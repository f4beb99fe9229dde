"""ClockScan shared scan (the ``scan`` op): every query's conjunctive
range predicate against every row, bit-packed 32 queries to a word.

The kernel is ``csrc/clockscan.cu`` (it replaces the JAX package's
``repro/kernels/clockscan.py::clockscan_pallas``): a persistent grid of
``grid_blocks`` blocks, each staging lo/hi once in shared memory and
walking tiles of ``32 * rt`` rows; lanes are rows (coalesced column
loads), a warp builds its rows' words for every ``g``-th word of the
window, and the tile's words leave through shared memory in 16-byte
stores (``tile_geometry``).  Rows need no padding: the kernel stops at T.
"""
from __future__ import annotations

import torch

from repro_torch import kernels as _k
from repro_torch.kernels import ref

# lo/hi live in the block's shared memory: 2 * C * Q int32 <= 48 KB
MAX_PREDICATES = 48 * 1024 // 8
WARPS = 8                  # warps a block (kWarpsPerBlock in the kernel)


def tile_geometry(W: int):
    """(rt, g) for a window of ``W`` words: a block tile holds ``rt``
    subtiles of 32 rows, and the ``g`` warps of each subtile take every
    ``g``-th word (``rt * g <= WARPS``; warps past ``rt * g`` idle)."""
    g = min(W, WARPS)
    return WARPS // g, g


def grid_blocks(T: int, W: int, sms: int) -> int:
    """Blocks of one launch: one per block tile, at most
    ``kernels.BLOCKS_PER_SM`` a streaming multiprocessor."""
    rt, _ = tile_geometry(W)
    return max(1, min(-(-T // (32 * rt)), sms * _k.BLOCKS_PER_SM))


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
            or Q % 32 or Q < 32 or C < 1 or C * Q > MAX_PREDICATES):
        raise ValueError(f"clockscan: cols {tuple(cols.shape)}, lo "
                         f"{tuple(lo.shape)}, hi {tuple(hi.shape)}, valid "
                         f"{tuple(valid.shape)}: want C >= 1, Q % 32 == 0, "
                         f"Q >= 32, C*Q <= {MAX_PREDICATES}")
    W = Q // 32
    rt, g = tile_geometry(W)
    out = torch.empty((T, W), dtype=torch.int32, device=dev)
    code = _k.library().shareddb_clockscan(
        cols.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        valid.view(torch.uint8).data_ptr(), out.data_ptr(), C, T, Q, rt, g,
        grid_blocks(T, W, _k.sm_count(dev)), _k.stream_of(cols))
    _k.count_launch("clockscan")
    _k.check_launch(code, "clockscan")
    return out
