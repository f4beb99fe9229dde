"""Mutation: a full-window range compare reachable on the delta path.

The mutant is the REAL delta beat, recorded, plus one (capacity,
q_window) ``ge`` over the widest predicated stage — the full-rescan work
shape a botched pane-slicing refactor would reintroduce.  The width
classifier must flag it.
"""
EXPECT = "jaxpr-delta-width"


def findings(ctx):
    import torch

    from repro_torch.analysis_static.trace_passes import (OpRecorder,
                                                          lint_delta_width)
    lowered, eng = ctx["lowered"], ctx["engine"]()
    st = max((s for s in lowered.scans
              if s.cols and 32 * s.delta_words < s.q_window),
             key=lambda s: s.q_window)
    col = eng.state[st.table][st.cols[0]]
    with OpRecorder() as rec:
        _ = col[:, None] >= torch.zeros((1, st.q_window), dtype=col.dtype)
    compares = ctx["records"]()["delta"].compares + rec.compares
    return lint_delta_width(compares, lowered, location="mutant delta")
