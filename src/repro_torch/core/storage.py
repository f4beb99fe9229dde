"""Columnar storage manager on PyTorch tensors.

The Crescando-style storage layer of the paper (§4.4): tables are
fixed-capacity columnar int32 tensors (strings dictionary-encoded, money
in cents, dates as int days), one dict per table.  Updates (insert /
update / delete) are applied *in arrival order* at the start of each
heartbeat through fixed-capacity batches, so every select of heartbeat k
sees exactly the updates admitted to heartbeat k.

Every function here is out of place (it returns new tensors and leaves
its inputs as they were), launches no host synchronisation, and keeps
the static shapes of the JAX package: a fixed-size row list is built with
a cumsum and a scatter (``nonzero_static``) instead of ``torch.nonzero``,
and a scatter that must drop some slots writes them to a spare tail
element that is cut off afterwards (``_scatter_drop``).

Primary-key tables keep a dense key->row index (``_pk_index``) so shared
PK-FK joins are O(1) gathers; index-less PK tables are range-partitioned
into fixed-capacity key buckets once per heartbeat
(``build_key_partitions``) for the partitioned join.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.device import resolve_device

INT_SENTINEL = 2147483647   # reserved: never a live key


@dataclasses.dataclass(frozen=True)
class TableSchema:
    name: str
    columns: Tuple[str, ...]
    capacity: int
    pk: Optional[str] = None      # primary-key column
    # max pk value + 1 (dense index size); 0 with pk set means "unique
    # key but unbounded domain": no dense index, joins into the table
    # take the index-less access paths (core/lowering.py)
    key_space: int = 0
    # fixed capacity of the per-heartbeat dirty-row set (apply_updates);
    # a batch touching more rows sets ``_dirty_overflow`` and the
    # executor falls back to a full rescan for that heartbeat
    dirty_cap: int = 128

    @property
    def indexed(self) -> bool:
        return bool(self.pk) and self.key_space > 0


def empty_table(schema: TableSchema, device=None) -> Dict:
    device = resolve_device(device)
    i32 = dict(dtype=torch.int32, device=device)
    t = {c: torch.zeros((schema.capacity,), **i32) for c in schema.columns}
    t["_valid"] = torch.zeros((schema.capacity,), dtype=torch.bool,
                              device=device)
    t["_n"] = torch.zeros((), **i32)            # append cursor
    t["_version"] = torch.zeros((), **i32)
    # dirty-row set of the LAST applied batch: ascending distinct row ids
    # padded with the ``capacity`` sentinel
    t["_dirty_rows"] = torch.full((schema.dirty_cap,), schema.capacity,
                                  **i32)
    t["_dirty_n"] = torch.zeros((), **i32)
    t["_dirty_overflow"] = torch.zeros((), dtype=torch.bool, device=device)
    if schema.indexed:
        t["_pk_index"] = torch.full((schema.key_space,), -1, **i32)
    return t


def bulk_load(schema: TableSchema, data: Dict[str, np.ndarray],
              device=None) -> Dict:
    """Load host arrays (all the same length) into a fresh table
    (``device=None``: the CUDA card)."""
    device = resolve_device(device)
    n = len(next(iter(data.values())))
    if n > schema.capacity:
        raise ValueError(f"bulk_load of {schema.name}: {n} rows exceed "
                         f"capacity {schema.capacity}")
    t = empty_table(schema, device)
    for c in schema.columns:
        t[c][:n] = torch.as_tensor(np.asarray(data[c], np.int32),
                                   device=device)
    t["_valid"][:n] = True
    t["_n"].fill_(n)
    if schema.indexed:
        t["_pk_index"][t[schema.pk][:n].long()] = torch.arange(
            n, dtype=torch.int32, device=device)
    return t


def tree_to_torch(tree, device=None):
    """Nested dicts/tuples/lists of arrays -> the same tree of tensors.

    uint32 arrays (the JAX package's bitmask words) become int32 tensors
    holding the same bit patterns; every other dtype keeps its type.
    ``device=None``: the CUDA card."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_to_torch(v, device) for v in tree)
    a = np.asarray(tree)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.tensor(a, device=device)


def state_from_numpy(catalog: "Catalog", tables: Dict,
                     device=None) -> Dict:
    """A reference table state -> the port's tensors.

    ``tables`` maps each table name to its dict of arrays (the JAX
    engine's ``state``, any array type ``np.asarray`` reads): columns,
    ``_valid``, cursors, dirty sets and the dense index, so a run can
    start from the same mid-stream snapshot in both packages.
    ``device=None``: the CUDA card."""
    device = resolve_device(device)
    out = {}
    for name, schema in catalog.schemas.items():
        t = tables[name]
        missing = [c for c in schema.columns + ("_valid", "_n")
                   if c not in t]
        if missing:
            raise KeyError(f"table {name} lacks {missing}")
        out[name] = tree_to_torch(dict(t), device)
    return out


# ---------------------------------------------------------------------------
# Update batches: fixed-capacity, applied in arrival order.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class UpdateSlots:
    """Static shape of a table's per-heartbeat update batch."""
    n_insert: int
    n_update: int
    n_delete: int


# fill defaults for the mutable batch fields: the executor's staging
# buffers reset exactly these between heartbeats (everything else is
# masked out and may hold stale values)
UPDATE_BATCH_RESET = {"ins_mask": False, "upd_mask": False,
                      "del_mask": False, "upd_key": -1, "del_key": -1}


def empty_update_batch(schema: TableSchema, slots: UpdateSlots,
                       xp=np) -> Dict:
    """One table's fixed-capacity update batch.

    ``xp`` is the array namespace, numpy (the executor's host staging
    layout) or torch — ONE layout definition either way."""
    int32 = xp.int32
    return {
        "ins_rows": {c: xp.zeros((slots.n_insert,), dtype=int32)
                     for c in schema.columns},
        "ins_mask": xp.zeros((slots.n_insert,), dtype=bool),
        # updates: set column `upd_col[i]` of row with pk `upd_key[i]`
        "upd_key": xp.full((slots.n_update,), -1, dtype=int32),
        "upd_col": xp.zeros((slots.n_update,), dtype=int32),
        "upd_val": xp.zeros((slots.n_update,), dtype=int32),
        "upd_mask": xp.zeros((slots.n_update,), dtype=bool),
        "del_key": xp.full((slots.n_delete,), -1, dtype=int32),
        "del_mask": xp.zeros((slots.n_delete,), dtype=bool),
    }


# ---------------------------------------------------------------------------
# Static-shape helpers (no host synchronisation)
# ---------------------------------------------------------------------------


def nonzero_static(flags, size: int, fill: int):
    """int64[size]: the first ``size`` indices where ``flags`` is set,
    ascending, padded with ``fill`` — ``jnp.nonzero(size=, fill_value=)``
    without the host round trip of ``torch.nonzero``."""
    n = flags.shape[0]
    pos = torch.cumsum(flags.to(torch.int64), 0) - 1
    slot = torch.where(flags & (pos < size), pos, size)
    out = torch.full((size + 1,), fill, dtype=torch.int64,
                     device=flags.device)
    out.scatter_(0, slot, torch.arange(n, device=flags.device))
    return out[:size]


def _take(x, idx):
    """``x[idx]`` with jnp's gather semantics: negative indices count
    from the end, the rest clamp into range (a CUDA gather must never
    read out of bounds)."""
    n = x.shape[0]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return x[idx]


def _scatter_drop(x, idx, vals):
    """``x.at[idx].set(vals, mode="drop")``, out of place.

    Slots whose index lies outside ``[0, len(x))`` are dropped: they
    write a spare tail element that is cut off.  Live indices must be
    distinct (callers resolve duplicates with ``_last_writer``)."""
    n = x.shape[0]
    idx = idx.long()
    idx = torch.where((idx >= 0) & (idx < n), idx, n)
    if not isinstance(vals, torch.Tensor):
        vals = torch.full(idx.shape, vals, dtype=x.dtype, device=x.device)
    ext = torch.cat([x, x[:1]])
    ext.index_put_((idx,), vals.to(x.dtype))
    return ext[:n]


def _last_writer(idx, live):
    """bool: slot i is live and no later live slot writes the same index
    — arrival order makes the last write of a batch win."""
    same = (idx[:, None] == idx[None, :]) & live[None, :]
    later = torch.ones(same.shape, dtype=torch.bool,
                       device=idx.device).triu(1)
    return live & ~(same & later).any(dim=1)


# ---------------------------------------------------------------------------
# Key partitions (the partitioned join's access path)
# ---------------------------------------------------------------------------


def build_key_partitions(keys, valid, n_partitions: int, bucket_cap: int):
    """Range-partition a key column into fixed-capacity buckets.

    Valid rows are sorted by key (row id breaks ties ascending) and split
    into ``n_partitions`` contiguous buckets of exactly ``bucket_cap``
    entries, so no bucket can overflow.  Invalid rows and padding sort to
    the tail under the ``INT_SENTINEL`` key with row id -1.

    Returns (bucket_keys int32[P, B], bucket_rows int32[P, B] (-1 = pad),
    bounds int32[P] — each bucket's smallest key).  A key k lives in the
    LAST bucket whose bound <= k, so duplicates resolve to the max row.

    ``jnp.lexsort((rows, keys, invalid))`` becomes two chained stable
    sorts: by key (stable, so rows stay ascending among equal keys),
    then by validity."""
    T = keys.shape[0]
    cap = n_partitions * bucket_cap
    if cap < T:
        raise ValueError(f"partition capacity {cap} < table capacity {T}")
    invalid = ~valid
    order = torch.argsort(keys, stable=True)
    order = order[torch.argsort(invalid[order].to(torch.int32),
                                stable=True)]
    inv = invalid[order]
    skeys = torch.where(inv, INT_SENTINEL, keys[order])
    srows = torch.where(inv, -1, order.to(torch.int32))
    skeys = torch.nn.functional.pad(skeys, (0, cap - T), value=INT_SENTINEL)
    srows = torch.nn.functional.pad(srows, (0, cap - T), value=-1)
    bucket_keys = skeys.reshape(n_partitions, bucket_cap)
    bucket_rows = srows.reshape(n_partitions, bucket_cap)
    return bucket_keys, bucket_rows, bucket_keys[:, 0].contiguous()


def scatter_dirty_rows(dst, rows, vals, capacity: int):
    """Scatter per-dirty-row values into a row-indexed tensor, out of
    place.

    ``rows`` is a ``_dirty_rows`` set (ascending distinct row ids padded
    with the ``capacity`` sentinel); ``vals`` holds one update per slot
    (leading axis D).  Pad slots write spare tail rows, one each, which
    are cut off — the reference's ``mode="drop"`` scatter."""
    D = rows.shape[0]
    n = dst.shape[0]
    rows = rows.long()
    idx = torch.where(rows >= capacity,
                      n + torch.arange(D, device=rows.device), rows)
    ext = torch.cat([dst, dst.new_zeros((D,) + tuple(dst.shape[1:]))])
    ext.index_copy_(0, idx, vals.to(dst.dtype))
    return ext[:n]


def partitions_stale(table: Dict):
    """True iff this heartbeat's batch could have changed the table's key
    partitions (a 0-d bool tensor)."""
    return (table["_dirty_n"] > 0) | table["_dirty_overflow"]


def refresh_key_partitions(table: Dict, pk_col: str, n_partitions: int,
                           bucket_cap: int, prev):
    """Rebuild a table's key partitions only if this heartbeat dirtied
    it: ``(partitions, rebuilt)``.

    The reference's ``lax.cond`` becomes a ``torch.where`` over both
    branches — the decision stays on the device and the heartbeat never
    waits for the host.  Rebuilding an untouched table is idempotent, so
    the select is exact either way."""
    stale = partitions_stale(table)
    fresh = build_key_partitions(table[pk_col], table["_valid"],
                                 n_partitions, bucket_cap)
    return tuple(torch.where(stale, f, p)
                 for f, p in zip(fresh, prev)), stale


def locate_rows_by_key(keys_col, probe, valid):
    """Row holding key ``probe[i]`` among valid rows (-1 = absent).

    Broadcast key-equality scan for tables WITHOUT a dense pk index; a
    duplicate key resolves to the max row id."""
    eq = (keys_col[None, :] == probe[:, None]) & valid[None, :]
    rows = torch.arange(keys_col.shape[0], dtype=torch.int32,
                        device=keys_col.device)
    return torch.where(eq, rows[None, :], -1).max(dim=1).values


def apply_updates(schema: TableSchema, table: Dict, batch: Dict,
                  commit_cap: Optional[int] = None) -> Dict:
    """Deletes, then column updates, then inserts — all in slot order.

    Slot order IS arrival order: the executor fills slots FIFO, and a
    later slot writing the same (row, column) or key as an earlier one
    wins.  ``commit_cap`` bounds the rows inserts may land in (default:
    the schema capacity); inserts past it are dropped and never dirty,
    though the append cursor still advances.

    Also maintains the dirty-row set: ``_dirty_rows`` (int32[dirty_cap],
    ascending distinct touched rows padded with the ``capacity``
    sentinel), ``_dirty_n`` (distinct rows, clamped to the set) and
    ``_dirty_overflow`` (the batch touched more rows than the set holds).
    """
    t = dict(table)
    n = t["_n"]
    cap = schema.capacity
    touched = []                 # dirty-row candidates, -1 = no-op slot

    if schema.pk:
        def locate(keys, mask, valid):
            """Row holding pk `keys[i]` (-1 absent/masked): an O(1)
            index gather, or a key-equality scan without the index."""
            if schema.indexed:
                return torch.where(mask, _take(t["_pk_index"], keys), -1)
            return torch.where(
                mask, locate_rows_by_key(t[schema.pk], keys, valid), -1)

        # deletes: invalidate row, clear pk index
        del_row = locate(batch["del_key"], batch["del_mask"], t["_valid"])
        touched.append(del_row)
        ok = del_row >= 0
        t["_valid"] = _scatter_drop(t["_valid"],
                                    torch.where(ok, del_row, cap), False)
        if schema.indexed:
            t["_pk_index"] = _scatter_drop(
                t["_pk_index"],
                torch.where(ok, batch["del_key"], schema.key_space), -1)

        # point updates by pk, against post-delete `_valid`/index so a
        # delete-then-update of one key in one batch finds nothing
        upd_row = locate(batch["upd_key"], batch["upd_mask"], t["_valid"])
        touched.append(upd_row)
        for ci, c in enumerate(schema.columns):
            sel = (batch["upd_col"] == ci) & (upd_row >= 0)
            sel = _last_writer(upd_row, sel)
            t[c] = _scatter_drop(t[c], torch.where(sel, upd_row, cap),
                                 torch.where(sel, batch["upd_val"], 0))

    # inserts: append at the cursor, in slot order
    cap_c = cap if commit_cap is None else commit_cap
    ins = batch["ins_mask"]
    landing = n + torch.cumsum(ins.to(torch.int32), 0,
                               dtype=torch.int32) - 1
    lands = ins & (landing < cap_c)
    rows = torch.where(lands, landing, cap)
    for c in schema.columns:
        t[c] = _scatter_drop(t[c], rows, batch["ins_rows"][c])
    t["_valid"] = _scatter_drop(t["_valid"], rows, True)
    if schema.indexed:
        keys = torch.where(ins, batch["ins_rows"][schema.pk],
                           schema.key_space)
        # a DROPPED insert indexes as absent (-1)
        t["_pk_index"] = _scatter_drop(
            t["_pk_index"],
            torch.where(_last_writer(keys, ins), keys, schema.key_space),
            torch.where(lands, landing, -1))
    t["_n"] = (n + ins.sum()).to(torch.int32)
    t["_version"] = t["_version"] + 1

    # dirty-row set: mark touched rows on a row bitmap, then compress to
    # the fixed-capacity sorted/unique id list the delta beat consumes
    touched.append(torch.where(lands, rows, -1))
    cand = torch.cat([x.to(torch.int32) for x in touched])
    D = t["_dirty_rows"].shape[0]
    dev = n.device
    if cand.shape[0] == 0:
        t["_dirty_rows"] = torch.full((D,), cap, dtype=torch.int32,
                                      device=dev)
        t["_dirty_n"] = torch.zeros((), dtype=torch.int32, device=dev)
        t["_dirty_overflow"] = torch.zeros((), dtype=torch.bool,
                                           device=dev)
        return t
    mark = _scatter_drop(torch.zeros((cap,), dtype=torch.bool, device=dev),
                         cand, True)
    count = mark.sum()
    t["_dirty_rows"] = nonzero_static(mark, D, cap).to(torch.int32)
    t["_dirty_n"] = torch.clamp(count, max=D).to(torch.int32)
    t["_dirty_overflow"] = count > D
    return t


class Catalog:
    """Schema registry + initial state construction."""

    def __init__(self, schemas: List[TableSchema]):
        self.schemas = {s.name: s for s in schemas}

    def init_state(self, data: Dict[str, Dict[str, np.ndarray]],
                   device=None) -> Dict:
        """Every table loaded from ``data`` or empty, on ``device``
        (``None``: the CUDA card)."""
        device = resolve_device(device)
        return {name: bulk_load(s, data[name], device) if name in data
                else empty_table(s, device)
                for name, s in self.schemas.items()}
