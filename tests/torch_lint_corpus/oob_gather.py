"""Mutation: a dirty-row gather one past the end of its table.

The DIRTY item would read the row's columns and write its carried words
one row past the carry (someone else's memory).  The gather-bounds rule
must fire.
"""
EXPECT = "kernel-gather-bounds"


def findings(ctx):
    import numpy as np

    from repro_torch.analysis_static.kernel_passes import (
        lint_gather_bounds, synthesize_gathers)
    from repro_torch.kernels.fused_delta import _DIRTY
    geom = ctx["geometry"]
    desc, _ = ctx["descriptor"]
    gathers = synthesize_gathers(geom, desc)
    row = int(np.flatnonzero(desc[:, 0] == _DIRTY)[0])
    gathers[row, 0] = geom.T[int(desc[row, 1])]          # one past the end
    return lint_gather_bounds(geom, desc, gathers, location="mutant fused")
