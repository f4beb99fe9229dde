"""Kernels: shared_groupby's least time in the traced window (``bench/roofline/shared_groupby.py``)
over its device time (the mean of its kept trace events times its
launches), in %."""


def read(rec):
    least, dev = rec["least_s"].get("shared_groupby"), rec["kernel_s"].get("shared_groupby")
    return 100.0 * least / dev if least is not None and dev else None
