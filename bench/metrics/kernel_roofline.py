"""Kernels (``kernels/*.py``, ``kernels/csrc/*.cu``): the least time the
traced window's hand-kernel launches need (``bench/roofline``) over their
device time (the mean of the events the trace kept, times the launches
the program counted), in %, over the kernels whose least work is
counted."""


def read(rec):
    least = dev = 0.0
    for k, s in rec["kernel_s"].items():
        if rec["least_s"].get(k) is not None:
            least += rec["least_s"][k]
            dev += s
    return 100.0 * least / dev if dev else None
