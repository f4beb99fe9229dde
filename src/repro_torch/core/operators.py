"""Shared relational operators over the data-query model (paper §3.3-3.4).

Every operator processes the UNION of tuples needed by all concurrent
queries exactly once, carrying the packed query bitmask.  Worst-case work
is a function of table capacity only — never of the number of queries.

These are the operators the JAX package left to XLA (gathers, union
compression, sorts, routing); here they are plain torch ops, shared by
both backends and free of host synchronisation.  The hot loops (scan,
partitioned join, group-by, the fused delta beat) go through the operator
backend (core/backends.py).
"""
from __future__ import annotations

import torch

from repro_torch.core import dataquery as dq
from repro_torch.core.storage import nonzero_static

INT_MIN = -2147483647
INT_MAX = 2147483647


def shared_join_fk(fk, left_mask, pk_index, right_mask):
    """PK-FK shared join through a dense key index.

    fk int32[Tl]; left_mask int32[Tl, W]; pk_index int32[K] (-1 absent);
    right_mask int32[Tr, W].  Returns (right_row int32[Tl] (-1 = no
    match), combined int32[Tl, W] = left & right[match])."""
    K = pk_index.shape[0]
    safe_fk = fk.long().clamp(0, K - 1)
    r = torch.where((fk >= 0) & (fk < K), pk_index[safe_fk], -1)
    gathered = right_mask[r.long().clamp(0, right_mask.shape[0] - 1)]
    combined = torch.where((r >= 0)[:, None], left_mask & gathered, 0)
    return r, combined


def compress_union(mask, cap: int):
    """Extract the tuples at least one query wants, bounded by ``cap``.

    Returns (row_idx int32[cap] (-1 pad), cmask int32[cap, W], n_wanted
    int — n_wanted > cap means overflow; rows past the cap are dropped
    from the tail)."""
    T = mask.shape[0]
    wanted = dq.any_query(mask)
    n_wanted = wanted.sum().to(torch.int32)
    idx = nonzero_static(wanted, cap, T)
    live = idx < T
    safe = idx.clamp(max=T - 1)
    cmask = torch.where(live[:, None], mask[safe], 0)
    rows = torch.where(live, safe, -1).to(torch.int32)
    return rows, cmask, n_wanted


def shared_sort(sort_key, mask, descending: bool = False):
    """ONE stable sort over the union of interested tuples; the bitmask
    rides along.  Rows wanted by nobody sort to the end.
    Returns (perm, sorted_mask)."""
    wanted = dq.any_query(mask)
    key = torch.where(wanted, -sort_key if descending else sort_key,
                      INT_MAX)
    perm = torch.sort(key, stable=True).indices
    return perm, mask[perm]


def shared_topn(sorted_mask, n_per_query):
    """Per-query rank filter: keep each query's first n bits (in order)."""
    bits = dq.unpack(sorted_mask)                    # [T, Q]
    rank = torch.cumsum(bits.to(torch.int32), 0, dtype=torch.int32)
    return dq.pack(bits & (rank <= n_per_query[None, :]))


def _route(bits, rows, limit, max_results: int):
    """Scatter each query's first ``limit[q]`` set rows (in order) into
    its result row: int32[Q, max_results], -1 padded.  Kept (query, rank)
    pairs are distinct; every other pair writes a spare column that is
    cut off."""
    K, Q = bits.shape
    rank = torch.cumsum(bits.to(torch.int32), 0, dtype=torch.int32) - 1
    keep = bits & (rank < limit[None, :])
    slot = torch.where(keep, rank, max_results).long()
    qidx = torch.arange(Q, device=bits.device)[None, :].expand(K, Q)
    out = torch.full((Q, max_results + 1), -1, dtype=torch.int32,
                     device=bits.device)
    out.index_put_((qidx.reshape(-1), slot.reshape(-1)),
                   rows[:, None].expand(K, Q).reshape(-1).to(torch.int32))
    return out[:, :max_results]


def route_topn(mask_in_order, n_per_query, max_results: int, rows=None):
    """Fused shared Top-N + result routing (the paper's Gamma operator).

    mask_in_order int32[K, W] in output order; rows int32[K] storage row
    ids (-1 invalid; default the positional index); n_per_query
    int32[W*32].  Returns int32[Q, max_results] row ids (-1 padded)."""
    K = mask_in_order.shape[0]
    bits = dq.unpack(mask_in_order)                  # [K, Q]
    if rows is None:
        rows = torch.arange(K, dtype=torch.int32,
                            device=mask_in_order.device)
    bits = bits & (rows >= 0)[:, None]
    return _route(bits, rows, n_per_query.clamp(max=max_results),
                  max_results)


def route_results(mask_in_order, max_results: int, perm=None):
    """Per query: the first ``max_results`` row ids whose bit is set, in
    order (``perm`` maps positions back to storage rows).
    Returns int32[Q, max_results] row ids (-1 padded)."""
    T, W = mask_in_order.shape
    bits = dq.unpack(mask_in_order)
    rows = torch.arange(T, dtype=torch.int32, device=mask_in_order.device) \
        if perm is None else perm
    limit = torch.full((W * dq.WORD,), max_results, dtype=torch.int32,
                       device=mask_in_order.device)
    return _route(bits, rows, limit, max_results)


def topk_stable(score, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest values, ties
    broken toward the LOWER index (``torch.topk`` does not promise that,
    so this is a stable descending sort).  Returns (values, indices)."""
    vals, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
