"""Executor beat: the untraced window's seconds over the beats dispatched
in it, in ms a beat (``beat_ms.open`` and ``beat_ms.closed``)."""


def read(rec):
    return rec["window_s"] / rec["beats"] * 1e3 if rec["beats"] else None
