"""Mutation: the donation spec donates the rid carry.

The rid carry of the delta-join flavour (argument 2) is the previous
slot's in-flight ``results["_join_rids"]``: a body allowed to write it in
place would corrupt a beat not yet collected.  The donation check must
refuse the spec.
"""
EXPECT = "jaxpr-donated-alias"


def findings(ctx):
    from repro_torch.analysis_static.trace_passes import lint_donation
    from repro_torch.core.executor import DONATION_SPEC
    spec = dict(DONATION_SPEC, delta_join=(0, 1, 2))
    return lint_donation(ctx["records"](), spec, location="mutant spec")
