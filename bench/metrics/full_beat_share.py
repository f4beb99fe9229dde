"""Lowering and path choice (``core/lowering.py``, the executor's
``_delta_eligible``): full-rescan beats over all beats dispatched in the
untraced window, from the engine's ``full_cycles`` / ``delta_cycles``."""


def read(rec):
    c = rec["cycles"]
    n = c["full"] + c["delta"] + c["delta_join"]
    return c["full"] / n if n else None
