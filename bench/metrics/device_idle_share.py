"""Device: 1 - the beats' busy time over the untraced window, from CUDA
events on the serving stream (a beat is busy from its start event, or
the previous beat's end if later, to its end event), for ``.open`` and
``.closed``."""


def read(rec):
    w = rec["events_window_s"]
    return 1.0 - rec["events_busy_s"] / w if w else None
