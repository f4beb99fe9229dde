"""Plain NumPy reference of the TPC-W deployment: the tables, the update
rule and the 13 query templates, independent of the program.

Update rule (the program's storage layer documents the same): a beat's
writes are applied before its queries; per table, its deletes, then its
column updates, then its inserts, each in arrival order; an insert
appends a row at the table's cursor; a later update of the same row and
column wins.  Every query of the beat then sees exactly the writes
admitted up to and including its own beat.

Answers are exact: a row query returns spine row ids (``-1`` padded to
``max_results``), sorted by its sort column (ties by row id) or in row
order, cut at its limit; the group-by returns the ``top_k`` groups by
the sum of the aggregated column (ties toward the lower group), with
their sums and counts, over all ``n_groups`` groups.

Tables are unbounded here: an insert the program drops for lack of room
is a row the read-back (``readback_mismatches``) finds missing.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Tuple

import numpy as np

from bench.reference.schema import Table, Template

INT_MAX = 2147483647


class RefTable:
    """One table: growing int64 columns, a valid flag a row, the key ->
    row map of its primary key, and equality indexes (value -> ascending
    rows) on the columns that templates compare with a single value."""

    def __init__(self, schema: Table, data: Dict[str, np.ndarray],
                 indexed: Tuple[str, ...]):
        self.schema = schema
        cols = schema.columns
        n = len(data[cols[0]]) if data else 0
        size = max(16, 2 * n)
        self.col = {c: np.zeros(size, np.int64) for c in cols}
        for c in cols:
            if n:
                self.col[c][:n] = np.asarray(data[c], np.int64)
        self.valid = np.zeros(size, bool)
        self.valid[:n] = True
        self.n = n
        # bumped by every write: (table rows) and one per column
        self.rows_version = 0
        self.col_version = {c: 0 for c in cols}
        self.key2row = np.full(16, -1, np.int64)
        if schema.pk:
            keys = self.col[schema.pk][:n]
            if n:
                self._grow_keys(int(keys.max()))
                # a duplicated key maps to its highest row
                self.key2row[keys] = np.arange(n)
        self.index = {}
        for c in indexed:
            order = np.argsort(self.col[c][:n], kind="stable")
            vals = self.col[c][:n][order]
            starts = np.flatnonzero(np.r_[True, vals[1:] != vals[:-1]]) \
                if n else np.zeros(0, np.int64)
            ends = np.r_[starts[1:], n] if n else starts
            self.index[c] = {int(vals[s]): order[s:e].tolist()
                             for s, e in zip(starts, ends)}

    def _grow_keys(self, key: int) -> None:
        if key >= self.key2row.shape[0]:
            grown = np.full(max(2 * self.key2row.shape[0], key + 1), -1,
                            np.int64)
            grown[:self.key2row.shape[0]] = self.key2row
            self.key2row = grown

    def _grow_rows(self) -> None:
        size = 2 * self.valid.shape[0]
        for c, a in self.col.items():
            g = np.zeros(size, np.int64)
            g[:a.shape[0]] = a
            self.col[c] = g
        v = np.zeros(size, bool)
        v[:self.valid.shape[0]] = self.valid
        self.valid = v

    def locate(self, key: int) -> int:
        """The valid row holding primary key ``key`` (-1: none)."""
        if key < 0 or key >= self.key2row.shape[0]:
            return -1
        return int(self.key2row[key])

    def locate_many(self, keys: np.ndarray) -> np.ndarray:
        ok = (keys >= 0) & (keys < self.key2row.shape[0])
        return np.where(ok, self.key2row[np.where(ok, keys, 0)], -1)

    def _unindex(self, r: int) -> None:
        for c, idx in self.index.items():
            lst = idx.get(int(self.col[c][r]))
            if lst is not None:
                lst.remove(r)

    def _reindex(self, r: int) -> None:
        for c, idx in self.index.items():
            bisect.insort(idx.setdefault(int(self.col[c][r]), []), r)

    def _rekey(self, key: int) -> None:
        """Point ``key`` at its highest valid row (after a delete)."""
        pk = self.col[self.schema.pk][:self.n]
        rows = np.flatnonzero((pk == key) & self.valid[:self.n])
        self.key2row[key] = rows[-1] if rows.size else -1

    def apply(self, deletes: List[int], updates: List[Tuple[int, str, int]],
              inserts: List[Dict[str, int]]) -> None:
        """One beat's batch for this table, each list in arrival order."""
        pk = self.schema.pk
        for key in deletes:
            r = self.locate(key) if pk else -1
            if r >= 0:
                self._unindex(r)
                self.valid[r] = False
                self._rekey(key)
                self.rows_version += 1
        # rows are located before any update of the batch is applied
        rows = [self.locate(key) if pk else -1 for key, _, _ in updates]
        for r, (_, c, v) in zip(rows, updates):
            if r >= 0:
                indexed = c in self.index
                if indexed:
                    self._unindex(r)
                self.col[c][r] = v
                if indexed:
                    self._reindex(r)
                self.col_version[c] += 1
        for payload in inserts:
            if self.n == self.valid.shape[0]:
                self._grow_rows()
            r = self.n
            for c in self.schema.columns:
                self.col[c][r] = int(payload[c])
            self.valid[r] = True
            self.n += 1
            self._reindex(r)
            if pk:
                key = int(payload[pk])
                self._grow_keys(key)
                self.key2row[key] = r
            self.rows_version += 1

    def snapshot(self, capacity: int) -> Dict:
        """The table as a program of ``capacity`` rows would hand it
        back (``readback_mismatches``' format): rows past it dropped."""
        n = min(self.n, capacity)
        snap = {}
        for c, a in self.col.items():
            snap[c] = np.zeros(capacity, np.int64)
            snap[c][:n] = a[:n]
        snap["_valid"] = np.zeros(capacity, bool)
        snap["_valid"][:n] = self.valid[:n]
        snap["_n"] = n
        return snap


class Reference:
    """The deployment's state and answers, beat by beat."""

    def __init__(self, tables: Dict[str, Table],
                 templates: Dict[str, Template], data: Dict,
                 max_results: int):
        self.templates = templates
        self.max_results = max_results
        eq_cols: Dict[str, set] = {}
        for t in templates.values():
            for table, c in t.preds:
                eq_cols.setdefault(table, set()).add(c)
        self.t = {name: RefTable(s, data.get(name, {}),
                                 tuple(sorted(eq_cols.get(name, ()))))
                  for name, s in tables.items()}
        # what each template reads: its answers are cached against the
        # versions of exactly these
        self._reads = {}
        for t in templates.values():
            reads = {(t.spine, None)}
            for table, c in t.preds:
                reads |= {(table, None), (table, c)}
            for fk, pk_table in t.joins:
                reads |= {(t.spine, fk), (pk_table, None),
                          (pk_table, tables[pk_table].pk)}
            for c in (t.sort, t.group, t.agg):
                if c:
                    reads.add((t.spine, c))
            self._reads[t.name] = tuple(sorted(reads, key=str))
        self._cache: Dict[tuple, dict] = {}

    # ------------------------------------------------------------ writes
    def apply_beat(self, writes: List[Tuple[str, str, dict]]) -> None:
        """One beat's admitted writes, in arrival order."""
        per: Dict[str, tuple] = {}
        for table, kind, payload in writes:
            d, u, i = per.setdefault(table, ([], [], []))
            if kind == "insert":
                i.append(payload)
            elif kind == "update":
                u.append((int(payload["key"]), payload["col"],
                          int(payload["val"])))
            elif kind == "delete":
                d.append(int(payload["key"]))
            else:
                raise ValueError(f"unknown write kind {kind!r}")
        for table, (d, u, i) in per.items():
            self.t[table].apply(d, u, i)

    # ----------------------------------------------------------- queries
    def _version(self, name: str) -> tuple:
        out = []
        for table, c in self._reads[name]:
            tb = self.t[table]
            out.append(tb.rows_version if c is None else tb.col_version[c])
        return tuple(out)

    def answer(self, name: str, params) -> dict:
        """The exact answer of one query (``params``: pred index ->
        inclusive (lo, hi))."""
        key = (name, tuple(sorted((int(k), (int(v[0]), int(v[1])))
                                  for k, v in params.items())),
               self._version(name))
        hit = self._cache.get(key)
        if hit is None:
            hit = self._cache[key] = self._answer(self.templates[name],
                                                  params)
        return hit

    def _answer(self, t: Template, params) -> dict:
        spine = self.t[t.spine]
        rows = None
        # a single-valued predicate on the spine picks its rows by index
        for pi, (table, c) in enumerate(t.preds):
            lo, hi = params[pi]
            if table == t.spine and lo == hi:
                rows = np.asarray(spine.index[c].get(int(lo), ()), np.int64)
                break
        if rows is None:
            rows = np.arange(spine.n)
        rows = rows[spine.valid[rows]]
        joined = {}
        for fk, pk_table in t.joins:
            pr = self.t[pk_table].locate_many(spine.col[fk][rows])
            keep = pr >= 0
            rows, pr = rows[keep], pr[keep]
            joined = {k: v[keep] for k, v in joined.items()}
            joined[pk_table] = pr
        for pi, (table, c) in enumerate(t.preds):
            lo, hi = params[pi]
            at = rows if table == t.spine else joined[table]
            v = self.t[table].col[c][at]
            keep = (v >= lo) & (v <= hi)
            rows = rows[keep]
            joined = {k: a[keep] for k, a in joined.items()}
        if t.group:
            codes = spine.col[t.group][rows]
            vals = spine.col[t.agg][rows]
            ok = (codes >= 0) & (codes < t.n_groups)
            sums = np.bincount(codes[ok], weights=vals[ok],
                               minlength=t.n_groups)
            counts = np.bincount(codes[ok], minlength=t.n_groups)
            top = np.lexsort((np.arange(t.n_groups), -sums))[:t.top_k]
            return {"groups": top.astype(np.int32),
                    "scores": sums[top].astype(np.float32),
                    "counts": counts[top].astype(np.float32)}
        if t.sort:
            v = spine.col[t.sort][rows]
            rows = rows[np.lexsort((rows, -v if t.desc else v))]
        else:
            rows = np.sort(rows)
        out = np.full(self.max_results, -1, np.int32)
        keep = rows[:min(t.limit, self.max_results)]
        out[:keep.shape[0]] = keep
        return {"rows": out}

    # ---------------------------------------------------------- read-back
    def readback_mismatches(self, name: str, snap: Dict) -> int:
        """Rows of table ``name`` that the program's snapshot (columns,
        ``_valid``, ``_n``, at its capacity) holds otherwise than the
        reference: a row valid on one side only, a valid row with any
        column different, and every reference row past the program's
        capacity (an insert it dropped); plus 1 when the append cursors
        differ."""
        tb = self.t[name]
        valid_p = np.asarray(snap["_valid"], bool)
        cap = valid_p.shape[0]
        n = min(tb.n, cap)
        ref_valid = tb.valid[:n]
        bad = valid_p[:n] != ref_valid
        both = valid_p[:n] & ref_valid
        for c in tb.schema.columns:
            got = np.asarray(snap[c])[:n].astype(np.int64)
            bad |= both & (got != tb.col[c][:n])
        out = int(bad.sum()) + int(valid_p[n:].sum())
        out += int(tb.valid[cap:tb.n].sum())
        return out + int(int(snap["_n"]) != tb.n)
