"""Mutation: one COPY tile appears twice in the descriptor.

Two warps would copy the same rids: harmless bits today, but a race the
moment a probe lands between them, and the one-writer contract the
kernel's rid output rests on is gone.  The one-writer replay
(``kernel-garbage-park``) must report rids with several writers.
"""
EXPECT = "kernel-garbage-park"


def findings(ctx):
    import numpy as np

    from repro_torch.analysis_static.kernel_passes import lint_garbage_park
    from repro_torch.kernels.fused_delta import _COPY
    geom = ctx["geometry"]
    desc, _ = ctx["descriptor"]
    first_copy = int(np.flatnonzero(desc[:, 0] == _COPY)[0])
    mutant = np.vstack([desc, desc[first_copy]])
    return lint_garbage_park(geom, mutant, location="mutant fused")
