"""Mutation: two templates' admission slot ranges overlap.

A plan whose offsets collide would route two templates' parameters into
the same admission bits — queries of one template would answer with the
other's predicate.  ``lint_slot_layout`` must refuse the layout.
"""
import dataclasses

EXPECT = "ir-slot-overlap"


def findings(ctx):
    from repro_torch.analysis_static.ir_passes import lint_slot_layout
    plan = ctx["plan"]
    names = sorted(plan.offsets, key=plan.offsets.get)
    a, b = names[0], names[1]
    offsets = dict(plan.offsets)
    offsets[b] = plan.offsets[a] + max(1, plan.caps[a] // 2)
    return lint_slot_layout(dataclasses.replace(plan, offsets=offsets))
