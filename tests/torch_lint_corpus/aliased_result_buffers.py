"""Mutation: two pipeline slots' results share a buffer.

Slot 1's body would overwrite, in place, a result that slot 0's beat —
still in flight, or the rid carry slot 1 reads — has not been collected
from.  The fixed-buffer check must find the shared storage.
"""
import dataclasses

EXPECT = "jaxpr-donated-alias"


def findings(ctx):
    from repro_torch.analysis_static.trace_passes import lint_buffer_aliasing
    eng = ctx["engine"]()
    h = eng._gen
    results = [dict(r) for r in h.results]
    name = next(k for k in results[0] if not k.startswith("_"))
    results[1][name] = results[0][name]
    return lint_buffer_aliasing(dataclasses.replace(h, results=results),
                                eng.state, location="mutant handle")
