"""Block shared join (the ``join_block`` op): each left key matched
against a small index-less PK side, then the query sets intersect.

The kernel is ``csrc/bitmask_join.cu`` (it replaces the JAX package's
``repro/kernels/bitmask_join.py::bitmask_join_pallas``): a persistent grid
of ``grid_blocks`` blocks; a warp owns 32 consecutive left rows at a
time (chunks dealt warp-major), each lane finds its row's rid — the
largest valid right row with an equal key — and the lanes stream the
chunk's contiguous rows x W words of ``mask_l`` and the output in
16-byte pieces, ``BATCH`` a lane in flight, each word's row from the
launch's ``reciprocal`` of W and its rid by shuffle.  When the right
side fits (``stage_bytes`` > 0) every block stages it once in shared
memory: ``mask_r``, and each right row as a 64-bit (invalid, key, row)
composite that each lane binary-searches when the staged order is
sorted.  Otherwise the warp finds rids by reading the right keys 32 at
a time; a right side that does not fit (the chunked path) also has its
``mask_r`` read from global memory.
Right keys are unique among valid rows by contract; invalid right rows
never match.
"""
from __future__ import annotations

import torch

from repro_torch import kernels as _k
from repro_torch.kernels import ref

WARPS = 8                  # warps a block (kWarpsPerBlock)
CHUNK = 32                 # left rows a warp owns at a time: one a lane
BATCH = 4                  # kBatch: 16-byte pieces a lane has in flight
# the staged path: mask_r plus the composites in at most half an SM's
# shared memory (227 KB), so that two blocks fit an SM; a larger right
# side takes the chunked path
STAGE_BYTES = 227 * 1024 // 2
# a word's row is floor(e / W) by the reciprocal ceil(2^32 / W), exact
# for e * W < 2^32 with e < 32 W
MAX_WORDS = 8192


def grid_blocks(Tl: int, sms: int) -> int:
    """Blocks of one launch: enough for every warp's chunk of CHUNK rows,
    at most ``kernels.BLOCKS_PER_SM`` a streaming multiprocessor; past
    one block an SM, a multiple of ``sms`` (chunks are dealt warp-major,
    so every SM then holds the same number of chunks, +- 1)."""
    want = max(1, -(-Tl // (CHUNK * WARPS)))
    cap = sms * _k.BLOCKS_PER_SM
    if want > sms:
        want = -(-want // sms) * sms
    return min(want, cap)


def stage_bytes(Tr: int, W: int) -> int:
    """Dynamic shared memory of the staged path — mask_r as Tr x W words
    (rounded up to 16 bytes), then Tr composites (8 bytes each) — or 0
    when the right side does not fit and the kernel takes the chunked
    path."""
    nbytes = 4 * ((Tr * W + 3) & ~3) + 8 * Tr
    if Tr < 1 or nbytes > STAGE_BYTES:
        return 0
    return nbytes


def reciprocal(W: int) -> int:
    """ceil(2^32 / W): floor(e / W) == (e * reciprocal(W)) >> 32 for
    every word index e of a chunk (e < CHUNK * W, W <= MAX_WORDS)."""
    return -(-(1 << 32) // W) if W else 0


def bitmask_join(keys_l, mask_l, keys_r, mask_r, valid_r):
    """-> (rid int32[Tl] (-1 = no match), combined int32[Tl, W])."""
    if keys_l.device.type == "cpu":
        return ref.bitmask_join_ref(keys_l, mask_l, keys_r, mask_r, valid_r)
    dev = keys_l.device
    _k.require(keys_l, torch.int32, 1, "keys_l", dev)
    _k.require(mask_l, torch.int32, 2, "mask_l", dev)
    _k.require(keys_r, torch.int32, 1, "keys_r", dev)
    _k.require(mask_r, torch.int32, 2, "mask_r", dev)
    _k.require(valid_r, torch.bool, 1, "valid_r", dev)
    Tl, W = mask_l.shape
    Tr = keys_r.shape[0]
    if (keys_l.shape[0] != Tl or mask_r.shape != (Tr, W)
            or valid_r.shape[0] != Tr or W > MAX_WORDS):
        raise ValueError(
            f"bitmask_join: keys_l {tuple(keys_l.shape)}, mask_l "
            f"{tuple(mask_l.shape)}, keys_r {tuple(keys_r.shape)}, mask_r "
            f"{tuple(mask_r.shape)}, valid_r {tuple(valid_r.shape)} "
            f"(W <= {MAX_WORDS})")
    rid = torch.empty((Tl,), dtype=torch.int32, device=dev)
    out = torch.empty((Tl, W), dtype=torch.int32, device=dev)
    code = _k.library().shareddb_bitmask_join(
        keys_l.data_ptr(), mask_l.data_ptr(), keys_r.data_ptr(),
        mask_r.data_ptr(), valid_r.view(torch.uint8).data_ptr(),
        rid.data_ptr(), out.data_ptr(), Tl, W, Tr,
        grid_blocks(Tl, _k.sm_count(dev)), stage_bytes(Tr, W),
        reciprocal(W), _k.stream_of(keys_l))
    _k.count_launch("bitmask_join")
    _k.check_launch(code, "bitmask_join")
    return rid, out
