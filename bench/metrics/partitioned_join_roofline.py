"""Kernels: partitioned_join's least time in the traced window (``bench/roofline/partitioned_join.py``)
over its device time (the mean of its kept trace events times its
launches), in %."""


def read(rec):
    least, dev = rec["least_s"].get("partitioned_join"), rec["kernel_s"].get("partitioned_join")
    return 100.0 * least / dev if least is not None and dev else None
