"""Shared group-by, phase 1 (the ``groupby`` op): per group and query, the
count of the query's rows in the group and the sum of their value.

The kernel is ``csrc/shared_groupby.cu`` (it replaces the JAX package's
``repro/kernels/shared_groupby.py::shared_groupby_pallas``): one
cooperative launch that zeroes the packed [2, G, Q] output itself, block
by block (``launch_geometry``), waits at one grid barrier, then walks
each (row, word)'s set bits (read before the zeroing) and adds atomically
into the outputs, instead of the reference's one-hot GEMM with its G-fold
waste.  The wrapper allocates and fills nothing else: a call is one
device op.  Counts are exact; sums are exact for integer values whose
partial sums stay below 2^24 (TPC-W's ol_qty), see the kernel's note.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import kernels as _k
from repro_torch.kernels import ref

# one cooperative launch zeroes and accumulates: one device op a call
DESIGN, DEVICE_OPS = "cooperative", 1
THREADS = 512              # kThreads: threads a block
# blocks a streaming multiprocessor at most: the grid barrier waits on the
# fewest blocks, and two launches in flight on two streams stay within the
# blocks it holds at once, as a cooperative grid must
GRID_BLOCKS_PER_SM = 1
UNIT = 4                   # floats of one 16-byte store
LINE = 8                   # 16-byte units of a 128-byte line


def launch_geometry(T: int, W: int, G: int, sms: int,
                    blocks_per_sm: int) -> tuple:
    """(blocks, stripe) of one launch over T rows of W words and G groups,
    on ``sms`` streaming multiprocessors that each hold ``blocks_per_sm``
    blocks of the kernel at once.

    Block b zeroes the 16-byte units [b * stripe, min((b + 1) * stripe,
    units)) of the 2 G W*32 floats (``units`` = 2 G W*32 / 4), so the
    stripes cover the buffer exactly once; a stripe is whole 128-byte
    lines, the last one ragged, and late blocks may get none.  The grid
    is enough blocks for one unit or one (row, word) a thread, and at most
    GRID_BLOCKS_PER_SM, and what the card holds at once, a streaming
    multiprocessor."""
    units = 2 * G * W * 32 // UNIT
    cap = sms * min(GRID_BLOCKS_PER_SM, blocks_per_sm)
    blocks = max(1, min(-(-max(units, T * W) // THREADS), cap))
    stripe = -(-units // blocks)
    return blocks, -(-stripe // LINE) * LINE


@functools.lru_cache(maxsize=None)
def blocks_per_sm() -> int:
    """Blocks of the kernel one streaming multiprocessor holds at once
    (the launcher's occupancy query, made once per process)."""
    n = ctypes.c_int(0)
    _k.check_launch(_k.library().shareddb_groupby_blocks_per_sm(
        ctypes.byref(n)), "shared_groupby occupancy")
    return n.value


def shared_groupby(group_code, values, mask, n_groups: int):
    """codes int32[T], values int32[T], mask int32[T, W], G
    -> (count f32[G, W*32], sum f32[G, W*32])."""
    if mask.device.type == "cpu":
        return ref.shared_groupby_ref(group_code, values, mask, n_groups)
    T, W = mask.shape
    dev = mask.device
    _k.require(group_code, torch.int32, 1, "group_code", dev)
    _k.require(values, torch.int32, 1, "values", dev)
    _k.require(mask, torch.int32, 2, "mask", dev)
    if group_code.shape[0] != T or values.shape[0] != T or n_groups < 1:
        raise ValueError(f"shared_groupby: codes {tuple(group_code.shape)}, "
                         f"values {tuple(values.shape)}, mask "
                         f"{tuple(mask.shape)}, G={n_groups}")
    out = torch.empty((2, n_groups, W * 32), dtype=torch.float32,
                      device=dev)
    blocks, stripe = launch_geometry(T, W, n_groups, _k.sm_count(dev),
                                     blocks_per_sm())
    code = _k.library().shareddb_groupby(
        group_code.data_ptr(), values.data_ptr(), mask.data_ptr(),
        out.data_ptr(), T, W, n_groups, blocks, stripe, _k.stream_of(mask))
    _k.count_launch("shared_groupby")
    _k.check_launch(code, "shared_groupby")
    return out[0], out[1]
