"""Partitioned shared join (the ``join_partitioned`` op): each left key
probes ONE range bucket of the right side's key partitions
(storage.build_key_partitions), then the query sets intersect.

The kernel is ``csrc/partitioned_join.cu`` (it replaces the JAX
package's ``repro/kernels/partitioned_join.py::partitioned_join_pallas``):
routing (a binary search over the bucket bounds), the probe of the one
bucket (a binary search inside it: the buckets come sorted) and the
``mask_l & mask_r[rid]`` intersection run fused, one lane per left row
and a warp per 32 consecutive rows, on a persistent grid of
``grid_blocks`` blocks; the reference's [Tl, B] candidate panes are never
built.
"""
from __future__ import annotations

import torch

from repro_torch import kernels as _k
from repro_torch.kernels import ref

WARPS = 8                  # warps a block (kWarpsPerBlock)
CHUNK = 32                 # left rows a warp owns at a time: one a lane
BATCH = 8                  # kBatch: intersect words a lane has in flight


def grid_blocks(Tl: int, sms: int) -> int:
    """Blocks of one launch: enough for every warp's chunk of CHUNK rows,
    at most ``kernels.BLOCKS_PER_SM`` a streaming multiprocessor."""
    return max(1, min(-(-Tl // (CHUNK * WARPS)), sms * _k.BLOCKS_PER_SM))


def buckets_ordered(bucket_keys, bucket_rows) -> bool:
    """Whether every bucket is laid out as the kernel's binary search
    needs, as ``storage.build_key_partitions`` lays it out: its live rows
    (row >= 0) first, by key ascending and row ids ascending among equal
    keys, then rows -1 only.  Plain torch; it synchronises (a bool)."""
    live = bucket_rows >= 0
    k, r = bucket_keys.long(), bucket_rows.long()
    prefix = live[:, 1:] <= live[:, :-1]
    ascending = (k[:, 1:] > k[:, :-1]) | \
        ((k[:, 1:] == k[:, :-1]) & (r[:, 1:] > r[:, :-1]))
    return bool((prefix & (ascending | ~live[:, 1:])).all())


def partitioned_join(keys_l, mask_l, bucket_keys, bucket_rows, bounds,
                     mask_r):
    """-> (rid int32[Tl] (-1 = no match), combined int32[Tl, W]).

    Precondition (not checked): the buckets are laid out as
    ``storage.build_key_partitions`` lays them out (``buckets_ordered``),
    which the kernel's binary search inside a bucket rests on; the plain
    version scans the bucket and does not need it."""
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
    if Tl == 0:
        return rid, out
    code = _k.library().shareddb_partitioned_join(
        keys_l.data_ptr(), mask_l.data_ptr(), bucket_keys.data_ptr(),
        bucket_rows.data_ptr(), bounds.data_ptr(), mask_r.data_ptr(),
        rid.data_ptr(), out.data_ptr(), Tl, W, P, B, Tr,
        grid_blocks(Tl, _k.sm_count(dev)), _k.stream_of(keys_l))
    _k.count_launch("partitioned_join")
    _k.check_launch(code, "partitioned_join")
    return rid, out
