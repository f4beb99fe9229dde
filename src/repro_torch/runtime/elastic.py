"""The drain -> re-lower -> resume recipe of elastic scaling, as data.

SharedDB's always-on plan is compiled for a fixed layout; changes to it
land at CYCLE boundaries, never inside a step.  The same skeleton drives
plan FOLDING (core/folding.py), where the re-lower happens in the
BACKGROUND while the old cycles keep serving and the drain/swap
collapses to a single beat boundary.  ``relower_recipe`` produces both
variants.  (The mesh ladder and re-meshing of ``repro.runtime.elastic``
belong to the port's sharding work and are not here.)
"""
from __future__ import annotations


def relower_recipe(current, target, *, what: str = "step functions",
                   background: bool = False) -> dict:
    """The drain -> re-lower -> resume recipe as structured data.

    ``background=False`` is the elastic-shrink variant (stop-the-world at
    a cycle boundary: drain, checkpoint, re-lower, restore).
    ``background=True`` is the plan-folding variant: the re-lower
    overlaps serving and only the swap itself lands at a beat boundary,
    so already-admitted clients keep their 2-cycle latency bound."""
    if background:
        steps = [
            f"re-lower {what} under {target} in the background "
            "(old compiled heartbeat keeps serving)",
            "drain in-flight beats at the next beat boundary",
            "migrate carries into the new layout (atomic swap)",
            "resume: first post-swap beat is a full-rescan reseed",
        ]
    else:
        steps = [
            "drain in-flight cycle",
            "checkpoint (atomic commit)",
            f"re-lower {what} under mesh {target}",
            "restore re-sharded checkpoint",
            "resume at saved step",
        ]
    return {"current": current, "target": target, "steps": steps}
