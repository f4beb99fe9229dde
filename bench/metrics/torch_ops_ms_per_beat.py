"""Operators (``core/operators.py``, the cycle bodies of
``core/lowering.py``, ``core/storage.py``'s update-apply and key
partitions): the profiler's device time of every operation that is not
a hand kernel, over the traced window's beats, in ms a beat (``.open``
and ``.closed``)."""


def read(rec):
    if not rec["traced_beats"] or not rec["trace"]["device_events"]:
        return None
    return rec["trace"]["torch_ops_s"] / rec["traced_beats"] * 1e3
