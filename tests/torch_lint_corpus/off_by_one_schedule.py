"""Mutation: the fused launch descriptor loses its last COPY tile.

A dropped COPY tile leaves a stretch of a join's rids with no writer:
the rid output is whatever the fresh tensor held.  The coverage rule
(and the item count of the grid-length rule) must fire.
"""
EXPECT = "kernel-schedule-coverage"


def findings(ctx):
    import numpy as np

    from repro_torch.analysis_static.kernel_passes import lint_fused_schedule
    from repro_torch.kernels.fused_delta import _COPY
    geom = ctx["geometry"]
    desc, n_block = ctx["descriptor"]
    last_copy = np.flatnonzero(desc[:, 0] == _COPY)[-1]
    return lint_fused_schedule(geom, np.delete(desc, last_copy, axis=0),
                               n_block, location="mutant fused")
