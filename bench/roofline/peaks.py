"""Peaks of one NVIDIA H100 SXM (80 GB HBM3) that a kernel's least time
is held to, at the card's full 700 W power limit.

``HBM_BYTES_PER_S`` is the data sheet's 3.35 TB/s.  The data sheet gives
no int32 rate: ``INT32_OPS_PER_S`` is derived, 64 int32 lanes a
streaming multiprocessor x 132 multiprocessors x the 1.98 GHz highest
SM clock, and bounds a kernel only where its compares outweigh its
bytes (the result names which rate bounds it).
"""
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9


def least_s(nbytes: float, nops: float) -> tuple:
    """(seconds, "bytes" | "int32 ops"): the least time of work that moves
    ``nbytes`` and makes ``nops`` int32 operations."""
    tb, to = nbytes / HBM_BYTES_PER_S, nops / INT32_OPS_PER_S
    return (tb, "bytes") if tb >= to else (to, "int32 ops")
