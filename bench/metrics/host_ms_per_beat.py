"""Executor host path (``core/executor.py`` ``dispatch`` / ``collect``):
the engine's own host seconds of a beat (``last_collect_stats``'
staging + dispatch + collect spans), summed over the untraced window's
beats, in ms a beat (``.open`` and ``.closed``)."""


def read(rec):
    return rec["host_s"] / rec["beats"] * 1e3 if rec["beats"] else None
