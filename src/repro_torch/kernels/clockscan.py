"""ClockScan shared scan (the ``scan`` op): every query's conjunctive
range predicate against every row, bit-packed 32 queries to a word.

The kernel is ``csrc/clockscan.cu`` (it replaces the JAX package's
``repro/kernels/clockscan.py::clockscan_pallas``): one warp per row, the
32 lanes of a warp are the 32 query bits of a word, packed with
``__ballot_sync``; the block keeps lo/hi in shared memory.  Rows need no
padding: the kernel stops at T.
"""
from __future__ import annotations

import torch

from repro_torch import kernels as _k
from repro_torch.kernels import ref

# lo/hi live in the block's shared memory: 2 * C * Q int32 <= 48 KB
MAX_PREDICATES = 48 * 1024 // 8


def clockscan(cols, lo, hi, valid):
    """cols int32[C,T]; lo/hi int32[C,Q]; valid bool[T] -> int32[T,Q/32]."""
    if cols.device.type == "cpu":
        return ref.clockscan_ref(cols, lo, hi, valid)
    C, T = cols.shape
    Q = lo.shape[1]
    dev = cols.device
    for t, name in ((cols, "cols"), (lo, "lo"), (hi, "hi")):
        _k.require(t, torch.int32, 2, name, dev)
    _k.require(valid, torch.bool, 1, "valid", dev)
    if (hi.shape != lo.shape or lo.shape[0] != C or valid.shape[0] != T
            or Q % 32 or C < 1 or C * Q > MAX_PREDICATES):
        raise ValueError(f"clockscan: cols {tuple(cols.shape)}, lo "
                         f"{tuple(lo.shape)}, hi {tuple(hi.shape)}, valid "
                         f"{tuple(valid.shape)}: want C >= 1, Q % 32 == 0, "
                         f"C*Q <= {MAX_PREDICATES}")
    out = torch.empty((T, Q // 32), dtype=torch.int32, device=dev)
    code = _k.library().shareddb_clockscan(
        cols.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        valid.view(torch.uint8).data_ptr(), out.data_ptr(), C, T, Q,
        _k.stream_of(cols))
    _k.LAUNCHES["clockscan"] += 1
    _k.check_launch(code, "clockscan")
    return out
