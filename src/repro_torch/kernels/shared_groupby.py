"""Shared group-by, phase 1 (the ``groupby`` op): per group and query, the
count of the query's rows in the group and the sum of their value.

The kernel is ``csrc/shared_groupby.cu`` (it replaces the JAX package's
``repro/kernels/shared_groupby.py::shared_groupby_pallas``): one thread
per (row, word) walks the word's set bits and adds atomically into the
[G, Q] outputs, instead of the reference's one-hot GEMM with its G-fold
waste.  Counts are exact; sums are exact for integer values whose
partial sums stay below 2^24 (TPC-W's ol_qty), see the kernel's note.
"""
from __future__ import annotations

import torch

from repro_torch import kernels as _k
from repro_torch.kernels import ref


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
    count = torch.zeros((n_groups, W * 32), dtype=torch.float32, device=dev)
    ssum = torch.zeros((n_groups, W * 32), dtype=torch.float32, device=dev)
    code = _k.library().shareddb_groupby(
        group_code.data_ptr(), values.data_ptr(), mask.data_ptr(),
        count.data_ptr(), ssum.data_ptr(), T, W, n_groups,
        _k.stream_of(mask))
    _k.LAUNCHES["shared_groupby"] += 1
    _k.check_launch(code, "shared_groupby")
    return count, ssum
