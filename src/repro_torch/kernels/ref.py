"""Plain PyTorch versions of every op the ``torch`` backend registers.

Each is the semantic ground truth its hand-written kernel is held
against (``chip_smoke.py`` on the card, ``tests/test_torch_kernels.py``
against the JAX package on the CPU), the ``torch`` backend's
implementation, and what a kernel wrapper computes when it is handed CPU
tensors.  Bitmask words are int32 bit patterns (core/dataquery.py).
"""
from __future__ import annotations

import torch

from repro_torch.core import dataquery as dq
from repro_torch.core.storage import scatter_dirty_rows


def clockscan_ref(cols, lo, hi, valid):
    """cols int32[C,T]; lo/hi int32[C,Q]; valid bool[T] -> int32[T,Q/32].

    Bit q of row t is set iff the row is valid and every column c has
    lo[c, q] <= cols[c, t] <= hi[c, q]."""
    C, T = cols.shape
    ok = valid[:, None].expand(T, lo.shape[1])
    for c in range(C):
        x = cols[c][:, None]
        ok = ok & (x >= lo[c][None, :]) & (x <= hi[c][None, :])
    return dq.pack(ok)


def delta_scan_ref(cols, lo, hi, valid, rows):
    """Dirty-row rescan: ``clockscan_ref`` restricted to ``rows`` int32[D]
    -> int32[D, Q/32].  Out-of-range slots (the capacity sentinel pads)
    clamp to a real row and are dropped by the caller's scatter."""
    T = cols.shape[1]
    safe = rows.long().clamp(0, T - 1)
    return clockscan_ref(cols[:, safe], lo, hi, valid[safe])


def _route(bounds, keys, P: int):
    """Each key's ONE candidate bucket: the last whose bound <= key
    (``searchsorted(side="right") - 1``, clipped)."""
    b = torch.searchsorted(bounds, keys, right=True) - 1
    return b.clamp(0, P - 1)


def _probe(keys, bucket, bucket_keys, bucket_rows):
    """Max row of the routed bucket holding an equal key (-1 = none)."""
    ck = bucket_keys[bucket]                         # [N, B]
    cr = bucket_rows[bucket]
    hit = (ck == keys[:, None]) & (cr >= 0)
    return torch.where(hit, cr, -1).max(dim=1).values


def delta_join_ref(keys_l, rows, bucket_keys, bucket_rows, bounds):
    """Dirty-row partitioned probe: rid int32[D] for the spine rows
    ``rows`` (pad slots clamp to a real row and are dropped later)."""
    P = bucket_keys.shape[0]
    kd = keys_l[rows.long().clamp(0, keys_l.shape[0] - 1)]
    return _probe(kd, _route(bounds, kd, P), bucket_keys, bucket_rows)


def partitioned_join_ref(keys_l, mask_l, bucket_keys, bucket_rows, bounds,
                         mask_r):
    """Partitioned shared join probe.

    Each left key probes ONE bucket of the right side's key partitions
    (storage.build_key_partitions).  Returns (rid int32[Tl] (-1 = no
    match; duplicates resolve to the max row id), combined int32[Tl, W] =
    mask_l & mask_r[rid])."""
    P = bucket_keys.shape[0]
    rid = _probe(keys_l, _route(bounds, keys_l, P), bucket_keys,
                 bucket_rows)
    safe = rid.long().clamp(0, mask_r.shape[0] - 1)
    combined = torch.where((rid >= 0)[:, None], mask_l & mask_r[safe], 0)
    return rid, combined


def bitmask_join_ref(keys_l, mask_l, keys_r, mask_r, valid_r):
    """Block shared join; right keys UNIQUE among valid rows.

    Returns (rid int32[Tl] (-1 = no match), combined int32[Tl, W])."""
    eq = (keys_l[:, None] == keys_r[None, :]) & valid_r[None, :]
    rows = torch.arange(keys_r.shape[0], dtype=torch.int32,
                        device=keys_r.device)
    rid = torch.where(eq, rows[None, :], -1).max(dim=1).values
    safe = rid.long().clamp(0, mask_r.shape[0] - 1)
    combined = torch.where((rid >= 0)[:, None], mask_l & mask_r[safe], 0)
    return rid, combined


def shared_groupby_ref(group_code, values, mask, n_groups: int):
    """-> (count f32[G, Q], sum f32[G, Q]): per group g and query q, the
    number of rows of group g whose bit q is set, and the sum of their
    ``values``.  Group codes outside [0, G) contribute nothing."""
    bits = dq.unpack(mask).to(torch.float32)         # [T, Q]
    ok = (group_code >= 0) & (group_code < n_groups)
    g = torch.where(ok, group_code, n_groups).long()
    Q = bits.shape[1]
    count = bits.new_zeros((n_groups + 1, Q)).index_add_(0, g, bits)
    ssum = bits.new_zeros((n_groups + 1, Q)).index_add_(
        0, g, bits * values.to(torch.float32)[:, None])
    return count[:n_groups], ssum[:n_groups]


def fused_delta_ref(scan_in, join_in):
    """Whole-delta-beat version (backends.OperatorBackend.fused_delta).

    Per scan stage: merge the admission pane (a pane-width clockscan
    written at word column ``w0``) when ``span > 0``, then the dirty rows
    (a full-window rescan scattered by row) when ``dn > 0``, into the
    carried words.  Per carried join: merge the dirty spine rows'
    one-bucket probe into the carried rids when ``dn > 0``.  The
    reference's ``lax.cond`` skips become ``torch.where`` selects: both
    branches are computed and the decision stays on the device.  Out of
    place: the carries are not modified."""
    words = []
    for e in scan_in:
        T, w = e.carry.shape
        A = e.lo_p.shape[1] // dq.WORD
        pane = clockscan_ref(e.cols, e.lo_p, e.hi_p, e.valid)
        w0 = e.w0.long().clamp(0, w - A)
        at = (w0 + torch.arange(A, device=w0.device)).expand(T, A)
        m = torch.where(e.span > 0, e.carry.scatter(1, at, pane), e.carry)
        fresh = scatter_dirty_rows(
            m, e.rows, delta_scan_ref(e.cols, e.lo, e.hi, e.valid, e.rows),
            T)
        words.append(torch.where(e.dn > 0, fresh, m))
    rids = []
    for e in join_in:
        fresh = scatter_dirty_rows(
            e.rid_carry, e.rows,
            delta_join_ref(e.keys, e.rows, e.bkeys, e.brows, e.bounds),
            e.keys.shape[0])
        rids.append(torch.where(e.dn > 0, fresh, e.rid_carry))
    return tuple(words), tuple(rids)
