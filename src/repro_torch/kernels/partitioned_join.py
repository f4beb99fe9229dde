"""Partitioned shared join (the ``join_partitioned`` op): each left key
probes ONE range bucket of the right side's key partitions
(storage.build_key_partitions), then the query sets intersect.

The kernel is ``csrc/partitioned_join.cu`` (it replaces the JAX
package's ``repro/kernels/partitioned_join.py::partitioned_join_pallas``):
routing (a binary search over the bucket bounds), the probe of the one
bucket and the ``mask_l & mask_r[rid]`` intersection run fused, one warp
per left row; the reference's [Tl, B] candidate panes are never built.
"""
from __future__ import annotations

import torch

from repro_torch import kernels as _k
from repro_torch.kernels import ref


def partitioned_join(keys_l, mask_l, bucket_keys, bucket_rows, bounds,
                     mask_r):
    """-> (rid int32[Tl] (-1 = no match), combined int32[Tl, W])."""
    if keys_l.device.type == "cpu":
        return ref.partitioned_join_ref(keys_l, mask_l, bucket_keys,
                                        bucket_rows, bounds, mask_r)
    dev = keys_l.device
    _k.require(keys_l, torch.int32, 1, "keys_l", dev)
    _k.require(mask_l, torch.int32, 2, "mask_l", dev)
    _k.require(bucket_keys, torch.int32, 2, "bucket_keys", dev)
    _k.require(bucket_rows, torch.int32, 2, "bucket_rows", dev)
    _k.require(bounds, torch.int32, 1, "bounds", dev)
    _k.require(mask_r, torch.int32, 2, "mask_r", dev)
    Tl, W = mask_l.shape
    P, B = bucket_keys.shape
    Tr = mask_r.shape[0]
    if (keys_l.shape[0] != Tl or bucket_rows.shape != bucket_keys.shape
            or bounds.shape[0] != P or mask_r.shape[1] != W or P < 1
            or B < 1 or Tr < 1):
        raise ValueError(
            f"partitioned_join: keys {tuple(keys_l.shape)}, mask_l "
            f"{tuple(mask_l.shape)}, buckets {tuple(bucket_keys.shape)}/"
            f"{tuple(bucket_rows.shape)}, bounds {tuple(bounds.shape)}, "
            f"mask_r {tuple(mask_r.shape)}")
    rid = torch.empty((Tl,), dtype=torch.int32, device=dev)
    out = torch.empty((Tl, W), dtype=torch.int32, device=dev)
    code = _k.library().shareddb_partitioned_join(
        keys_l.data_ptr(), mask_l.data_ptr(), bucket_keys.data_ptr(),
        bucket_rows.data_ptr(), bounds.data_ptr(), mask_r.data_ptr(),
        rid.data_ptr(), out.data_ptr(), Tl, W, P, B, Tr,
        _k.stream_of(keys_l))
    _k.LAUNCHES["partitioned_join"] += 1
    _k.check_launch(code, "partitioned_join")
    return rid, out
