"""Block shared join (the ``join_block`` op): each left key matched
against a small index-less PK side, then the query sets intersect.

The kernel is ``csrc/bitmask_join.cu`` (it replaces the JAX package's
``repro/kernels/bitmask_join.py::bitmask_join_pallas``): one thread per
left row finds the largest valid right row with an equal key over right
keys staged through shared memory, then the block writes
``mask_l & mask_r[rid]`` for its rows with coalesced word accesses.
Right keys are unique among valid rows by contract; invalid right rows
never match.
"""
from __future__ import annotations

import torch

from repro_torch import kernels as _k
from repro_torch.kernels import ref


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
            or valid_r.shape[0] != Tr):
        raise ValueError(
            f"bitmask_join: keys_l {tuple(keys_l.shape)}, mask_l "
            f"{tuple(mask_l.shape)}, keys_r {tuple(keys_r.shape)}, mask_r "
            f"{tuple(mask_r.shape)}, valid_r {tuple(valid_r.shape)}")
    rid = torch.empty((Tl,), dtype=torch.int32, device=dev)
    out = torch.empty((Tl, W), dtype=torch.int32, device=dev)
    code = _k.library().shareddb_bitmask_join(
        keys_l.data_ptr(), mask_l.data_ptr(), keys_r.data_ptr(),
        mask_r.data_ptr(), valid_r.view(torch.uint8).data_ptr(),
        rid.data_ptr(), out.data_ptr(), Tl, W, Tr, _k.stream_of(keys_l))
    _k.LAUNCHES["bitmask_join"] += 1
    _k.check_launch(code, "bitmask_join")
    return rid, out
