"""Lowering: CompiledPlan -> explicit staged operator graph (the IR), and
the heartbeat cycles that execute it on PyTorch tensors.

``compile_plan`` (plan.py) performs the paper's *logical* optimization:
predicate pushdown and operator merging across templates (Fig. 2/3).
This module performs the *physical* lowering into a pipeline of stages

    update-apply -> shared scans -> shared joins
                 -> shared sorts / group-bys -> result routing

with every piece of static metadata (word windows, subscriber bitmasks,
slot layouts, bounded union caps, per-query limits) computed at lowering
time.  The IR half is the JAX package's, field for field: the stage
dataclasses hold numpy arrays, and ``lower_plan`` gives an equal
``LoweredPlan`` for the same plan.

Join access paths are chosen per node from table capacities: ``gather``
(a dense key->row index: an O(1) gather), ``partitioned`` (index-less PK
table of at least PARTITIONED_MIN_CAPACITY rows: each spine row probes
ONE range bucket) and ``block`` (small index-less PK table: a dense
key-equality compare).

The cycle half binds the stages to an operator backend (backends.py) and
a device.  Two flavours share everything but the scan phase:

  build_cycle        — full rescan: every scan re-evaluates the whole
                       table, seeding the carried scan words, key
                       partitions and join rids.
  build_delta_cycle  — incremental: each predicated scan re-evaluates
                       only (changed admission word columns) ∪ (the
                       update batch's dirty rows) against the carried
                       words; with ``delta_joins=True`` the non-gather
                       joins re-probe only the dirty spine rows.  With a
                       backend ``fused_delta`` op both collapse into ONE
                       launch; without it, the chained ops run.

Every cycle keeps the reference's static shapes and never waits for the
host: the device-scalar pane offset becomes an index tensor (gather /
scatter along the word axis) instead of a Python slice, and every
``lax.cond`` becomes a ``torch.where``.

A cycle marks its stage boundaries (``graphs.mark``, a no-op unless the
executor traces the beat): ``apply`` after update-apply, ``scan:<table>``
after each scan (``scan:delta`` after the chained delta ops,
``scan:fused`` after the fused one), ``join:<spine>.<fk>.<pk table>``
after each join (``join:delta`` after the chained dirty-row probe),
``sort:<spine>.<col>`` after each sort with its top-n routing,
``groupby:<spine>`` after each group-by and ``route:<spine>`` after each
unsorted routing pass.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import dataquery as dq
from repro_torch.core import operators as ops
from repro_torch.core.backends import (DeltaJoinIn, DeltaScanIn,
                                       FusedJoinIn, FusedScanIn,
                                       OperatorBackend)
from repro_torch.core.device import resolve_device, upload
from repro_torch.core.graphs import mark
from repro_torch.core.plan import CompiledPlan, GroupAgg
from repro_torch.core.storage import (INT_SENTINEL, apply_updates,
                                      build_key_partitions,
                                      locate_rows_by_key,
                                      refresh_key_partitions,
                                      scatter_dirty_rows)

INT_MIN = ops.INT_MIN
INT_MAX = ops.INT_MAX

# join access-path thresholds: an index-less PK table below the minimum
# capacity runs the dense block kernel; at or above it, the bucketed
# partitioned probe (bucket capacity targets one lane-friendly tile)
PARTITIONED_MIN_CAPACITY = 512
PARTITION_BUCKET_CAP = 256

# incremental scans: each stage's admission pane covers a CONTIGUOUS
# range of window_words / DELTA_PANE_DIVISOR words (min 1).  The pane is
# a static shape, paid on every delta heartbeat, so it trades
# steady-state cost against how much admission churn still qualifies for
# the delta path.
DELTA_PANE_DIVISOR = 8

# (template, q_offset_in_window, slot_capacity)
SlotRange = Tuple[str, int, int]


def _round_up_128(x: int) -> int:
    return ((max(1, x) + 127) // 128) * 128


def partition_layout(capacity: int,
                     stats: Optional[Dict[str, int]] = None
                     ) -> Tuple[int, int]:
    """(n_partitions, bucket_cap) for a PK table of this capacity.

    With measured key ``stats`` — {"n_live": valid rows, "max_dup":
    widest duplicate-key run}, recorded from the initial snapshot at
    engine-construction time — the bucket capacity adapts to real
    occupancy instead of the static PARTITION_BUCKET_CAP heuristic: a
    sparsely loaded table gets narrower buckets (a cheaper probe pane
    for the delta/fused kernels, whose work per dirty row is O(B)), and
    a duplicate-heavy key column gets buckets at least as wide as its
    widest run.  Correctness never depends on the layout — a key run
    spanning buckets p..q resolves to bucket q, which holds the run's
    tail (the max row id), for ANY bucket_cap — so stats steer only the
    probe pane width, rounded to a 128-lane multiple.  Stats are
    measured once and baked into the JoinStage: shapes stay static, the
    bounded-computation property holds.
    """
    if stats is None:
        bucket_cap = min(PARTITION_BUCKET_CAP, capacity)
        return -(-capacity // bucket_cap), bucket_cap
    occupancy = min(1.0, max(0, int(stats.get("n_live", capacity)))
                    / capacity)
    target = _round_up_128(int(PARTITION_BUCKET_CAP * occupancy))
    bucket_cap = min(capacity,
                     max(target, _round_up_128(int(stats.get("max_dup",
                                                             1)))))
    return -(-capacity // bucket_cap), bucket_cap


# ---------------------------------------------------------------------------
# Stage IR
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ScanStage:
    """One ClockScan pass over a base table for ALL referencing queries.

    The predicate scatter plan is precomputed at lowering time: given the
    packed admission buffers (params int32[qcap, P_max, 2], active
    bool[qcap]), the stage's whole lo/hi predicate matrix binds with one
    vectorized gather — ``covered`` marks window slots belonging to a
    referencing template, ``param_idx`` maps (predicated column, window
    slot) to the packed parameter row (-1 = unbound -> pass-all when
    active).

    ``delta_words`` is the stage's admission-pane capacity on the
    incremental path (``build_delta_cycle``): the CONTIGUOUS range of
    window words whose slots may change admission between consecutive
    heartbeats and still take the delta scan.  The pane recomputes
    exactly that many adjacent word columns over all rows, so a smaller
    capacity means a cheaper steady-state heartbeat but an earlier
    fallback to the full rescan — the executor checks the changed span
    host-side before dispatch.
    """
    table: str
    cols: Tuple[str, ...]
    wlo: int                                  # word window [wlo, whi)
    whi: int
    slots: Tuple[SlotRange, ...]              # referencing templates
    covered: np.ndarray                       # bool[q_window]
    param_idx: np.ndarray                     # int32[max(C,1), q_window]
    delta_words: int = 1                      # admission-pane word cap

    @property
    def q_window(self) -> int:
        return (self.whi - self.wlo) * 32


@dataclasses.dataclass(frozen=True)
class JoinStage:
    """One shared PK-FK join per (spine, fk, pk) signature.

    Non-``gather`` stages are DELTA-ELIGIBLE: their rid vector depends
    only on the spine's fk column and the PK table's snapshot — not on
    admission — so the executor carries it across heartbeats and
    ``build_delta_cycle(delta_joins=True)`` re-probes just the dirty
    spine rows, falling back to the full probe when the PK side was
    written (partitions rebuilt) or the dirty set overflowed.
    """
    spine: str
    fk_col: str
    pk_table: str
    kind: str                                 # "gather"|"partitioned"|"block"
    pk_col: str                               # key column on the PK side
    sub_mask: np.ndarray                      # uint32[W] subscriber words
    n_partitions: int = 0                     # partitioned kind only
    bucket_cap: int = 0

    @property
    def key(self) -> Tuple[str, str, str]:
        """The stage's identity in ``results["_join_rids"]`` / rid carry."""
        return (self.spine, self.fk_col, self.pk_table)


@dataclasses.dataclass(frozen=True)
class SortStage:
    """Shared sort over the bounded union + fused per-query top-n."""
    spine: str
    col: str
    desc: bool
    wlo: int
    whi: int
    sub_mask: np.ndarray                      # uint32[whi-wlo], window-local
    union_cap: int
    slots: Tuple[SlotRange, ...]


@dataclasses.dataclass(frozen=True)
class GroupStage:
    """Shared group-by: phase 1 over the union, phase 2 per query."""
    spine: str
    agg: GroupAgg
    wlo: int
    whi: int
    union_cap: int
    slots: Tuple[SlotRange, ...]


@dataclasses.dataclass(frozen=True)
class RouteStage:
    """Natural-order routing for unsorted templates, one pass per spine."""
    spine: str
    wlo: int
    whi: int
    sub_mask: np.ndarray                      # uint32[whi-wlo], window-local
    union_cap: int
    slots: Tuple[SlotRange, ...]


@dataclasses.dataclass(frozen=True)
class LoweredPlan:
    plan: CompiledPlan
    qcap: int
    W: int
    n_params_max: int                         # packed params depth P_max
    scans: Tuple[ScanStage, ...]
    joins: Tuple[JoinStage, ...]
    sorts: Tuple[SortStage, ...]
    groups: Tuple[GroupStage, ...]
    routes: Tuple[RouteStage, ...]
    limits: np.ndarray                        # int32[qcap] per-slot top-n

    def stages(self) -> Iterator[Tuple[str, object]]:
        """The staged execution order (the IR, for inspection/debug)."""
        for s in self.scans:
            yield "scan", s
        for j in self.joins:
            yield "join", j
        for s in self.sorts:
            yield "sort", s
        for g in self.groups:
            yield "group", g
        for r in self.routes:
            yield "route", r


# ---------------------------------------------------------------------------
# Lowering
# ---------------------------------------------------------------------------


def _slot_ranges(plan: CompiledPlan, names: List[str],
                 base: int) -> Tuple[SlotRange, ...]:
    return tuple((n, plan.offsets[n] - base, plan.caps[n]) for n in names)


def lower_plan(plan: CompiledPlan,
               key_stats: Optional[Dict[str, Dict[str, int]]] = None
               ) -> LoweredPlan:
    """Lower the compiled plan to the staged IR.

    ``key_stats`` optionally maps PK table name -> measured key skew
    ({"n_live", "max_dup"}, see ``partition_layout``) so partitioned
    joins adapt their bucket layout to real occupancy; the executor
    measures it from the initial snapshot.  ``None`` keeps the static
    layout (runtime relayout paths that have no snapshot in hand).
    """
    cat = plan.catalog
    W = plan.qcap // 32

    scans = []
    for table, node in plan.scans.items():
        wlo, whi = plan.word_range(node.referencing)
        base = wlo * 32
        q_sub = (whi - wlo) * 32
        # lowering-time predicate scatter plan: static gather indices into
        # the packed admission buffers (no python loops in the cycle)
        covered = np.zeros(q_sub, bool)
        for name in node.referencing:
            o = plan.offsets[name] - base
            covered[o:o + plan.caps[name]] = True
        param_idx = np.full((max(len(node.cols), 1), q_sub), -1, np.int32)
        for name, col_idx, pidx in node.bindings:
            o = plan.offsets[name] - base
            param_idx[col_idx, o:o + plan.caps[name]] = pidx
        scans.append(ScanStage(
            table=table, cols=tuple(node.cols), wlo=wlo, whi=whi,
            slots=_slot_ranges(plan, node.referencing, base),
            covered=covered, param_idx=param_idx,
            delta_words=max(1, (whi - wlo) // DELTA_PANE_DIVISOR)))

    joins = []
    for j in plan.joins:
        schema = cat.schemas[j.pk_table]
        if schema.pk is None:
            raise ValueError(
                f"join {j.spine}->{j.pk_table}: PK table has no key column")
        n_parts, bucket_cap = 0, 0
        if schema.key_space > 0:
            kind = "gather"
        elif schema.capacity >= PARTITIONED_MIN_CAPACITY:
            kind = "partitioned"
            n_parts, bucket_cap = partition_layout(
                schema.capacity,
                None if key_stats is None else key_stats.get(j.pk_table))
        else:
            kind = "block"
        joins.append(JoinStage(
            spine=j.spine, fk_col=j.fk_col, pk_table=j.pk_table,
            kind=kind, pk_col=schema.pk,
            sub_mask=plan.sub_mask(j.subscribers),
            n_partitions=n_parts, bucket_cap=bucket_cap))

    sorts = []
    for s in plan.sorts:
        wlo, whi = plan.word_range(s.subscribers)
        T = cat.schemas[s.spine].capacity
        sorts.append(SortStage(
            spine=s.spine, col=s.col, desc=s.desc, wlo=wlo, whi=whi,
            sub_mask=plan.sub_mask(s.subscribers)[wlo:whi],
            union_cap=min(T, plan.union_cap),
            slots=_slot_ranges(plan, s.subscribers, wlo * 32)))

    groups = []
    for g in plan.groups:
        wlo, whi = plan.word_range(g.subscribers)
        T = cat.schemas[g.spine].capacity
        groups.append(GroupStage(
            spine=g.spine, agg=g.agg, wlo=wlo, whi=whi,
            union_cap=min(T, plan.group_union_cap),
            slots=_slot_ranges(plan, g.subscribers, wlo * 32)))

    routed = {name for st in sorts + groups for name, _, _ in st.slots}
    by_spine: Dict[str, List[str]] = {}
    for name, t in plan.templates.items():
        if name not in routed:
            by_spine.setdefault(t.spine, []).append(name)
    routes = []
    for spine, names in by_spine.items():
        wlo, whi = plan.word_range(names)
        T = cat.schemas[spine].capacity
        routes.append(RouteStage(
            spine=spine, wlo=wlo, whi=whi,
            sub_mask=plan.sub_mask(names)[wlo:whi],
            union_cap=min(T, plan.union_cap),
            slots=_slot_ranges(plan, names, wlo * 32)))

    limits = np.ones(plan.qcap, np.int32)
    for name, t in plan.templates.items():
        o, c = plan.offsets[name], plan.caps[name]
        limits[o:o + c] = min(t.limit, plan.max_results)

    return LoweredPlan(
        plan=plan, qcap=plan.qcap, W=W, n_params_max=plan.n_params_max,
        scans=tuple(scans), joins=tuple(joins), sorts=tuple(sorts),
        groups=tuple(groups), routes=tuple(routes), limits=limits)




def check_extension_prefix(old: LoweredPlan, new: LoweredPlan) -> None:
    """Validate that ``new`` prefix-stably EXTENDS ``old`` at the stage
    level — the IR contract dynamic plan folding (core/folding.py) rests
    on: existing stages keep their position, scan windows only widen on
    the high side, predicated column lists only append, and join stages
    keep their access path.  The derivation checks are the planlint
    pass ``analysis_static.ir_passes.lint_extension_prefix`` (rule
    ``fold-prefix-stability``); raises ``ValueError`` naming the rule."""
    from repro_torch.analysis_static.diagnostics import raise_on_error
    from repro_torch.analysis_static.ir_passes import lint_extension_prefix
    raise_on_error(lint_extension_prefix(old, new), exc=ValueError)


# ---------------------------------------------------------------------------
# Executing the lowered graph: one heartbeat of the always-on plan
# ---------------------------------------------------------------------------
#
# Both flavours return ``carry = {"scan": {table: words}, "parts": {table:
# partitions}}`` for the executor to thread into the next heartbeat; the
# rid half of the carry travels through ``results["_join_rids"]``.


def _device_consts(lowered: LoweredPlan, device):
    """The lowering-time predicate scatter plans as device tensors, built
    once when a cycle is built (never inside a heartbeat)."""
    covered = [upload(s.covered, device) for s in lowered.scans]
    pidx = [upload(s.param_idx, device, torch.int64) for s in lowered.scans]
    return covered, pidx


def _build_apply_phase(lowered: LoweredPlan):
    """Update-apply + partition refresh (step 1, shared by all cycles)."""
    cat = lowered.plan.catalog
    # PK tables probed by partitioned joins: partition once per heartbeat,
    # shared by every join into the same table
    part_specs = {}
    for j in lowered.joins:
        if j.kind == "partitioned":
            part_specs.setdefault(
                j.pk_table, (j.pk_col, j.n_partitions, j.bucket_cap))

    def apply_phase(storage, updates, prev_parts=None):
        # apply updates in arrival order, then refresh the partitioned
        # joins' buckets from the fresh snapshot; with carried
        # ``prev_parts`` (delta cycles) an untouched table keeps its
        # partitions and ``rebuilt`` records which tables re-sorted
        storage = dict(storage)
        for table, batch in updates.items():
            storage[table] = apply_updates(cat.schemas[table],
                                           storage[table], batch)
        partitions, rebuilt = {}, {}
        for table, (pk_col, n_parts, bucket_cap) in part_specs.items():
            t = storage[table]
            if prev_parts is None:
                partitions[table] = build_key_partitions(
                    t[pk_col], t["_valid"], n_parts, bucket_cap)
                rebuilt[table] = torch.ones((), dtype=torch.bool,
                                            device=t["_valid"].device)
            else:
                partitions[table], rebuilt[table] = refresh_key_partitions(
                    t, pk_col, n_parts, bucket_cap, prev_parts[table])
        return storage, partitions, rebuilt

    return apply_phase


def _pane_window(st: ScanStage, covered, changed):
    """One stage's admission-pane geometry on the device: (span, w0,
    over) as int32 0-d tensors.

    ``span`` is the contiguous changed-word span over the stage's covered
    slots (0 = no admission change), ``w0`` the pane's first word column
    clamped so the static-width pane stays in range, and ``over`` the
    words by which the span exceeds the pane capacity (positive only on
    beats the executor should never have dispatched)."""
    base = st.wlo * 32
    w = st.whi - st.wlo
    A = st.delta_words
    qd = changed[base:base + st.q_window] & covered
    wch = qd.reshape(w, 32).any(dim=1).to(torch.int32)
    first = torch.argmax(wch)
    last = w - 1 - torch.argmax(wch.flip(0))
    span = torch.where(wch.any(), last - first + 1, 0).to(torch.int32)
    over = torch.clamp(span - A, min=0)
    w0 = torch.clamp(first, max=w - A).to(torch.int32)
    return span, w0, over


def _pseudo_partitions(pk_tbl, pk_col: str):
    """A block join's PK side as a single-bucket partition structure:
    the whole key column is one bucket with bound INT_MIN, invalid rows
    padded with the key sentinel and row id -1 — the encoding of
    ``storage.build_key_partitions``, so the one-bucket probe matches
    ``storage.locate_rows_by_key`` bit for bit."""
    keys = pk_tbl[pk_col]
    valid = pk_tbl["_valid"]
    bkeys = torch.where(valid, keys, INT_SENTINEL)[None, :]
    brows = torch.where(valid, torch.arange(keys.shape[0], dtype=torch.int32,
                                            device=keys.device), -1)[None, :]
    bounds = torch.full((1,), INT_MIN, dtype=torch.int32,
                        device=keys.device)
    return bkeys, brows, bounds


def _bind_predicates(st: ScanStage, covered, pidx, queries):
    """One stage's (qok, lo, hi) from the packed admission buffers, in
    one vectorized gather (the scatter plan is precomputed)."""
    base = st.wlo * 32
    act = queries["active"][base:base + st.q_window]
    qok = act & covered                          # admitted subscribers
    p = queries["params"][base:base + st.q_window]
    bound = pidx >= 0
    safe = pidx.clamp(min=0)
    qs = torch.arange(st.q_window, device=p.device)[None, :]
    p_lo = p[qs, safe, 0]                        # [C, q_window]
    p_hi = p[qs, safe, 1]
    lo = torch.where(qok[None, :], torch.where(bound, p_lo, INT_MIN),
                     INT_MAX)
    hi = torch.where(qok[None, :], torch.where(bound, p_hi, INT_MAX),
                     INT_MIN)
    return qok, lo, hi


def _degenerate_scan(st: ScanStage, tbl, covered, queries):
    """A scan with no predicated columns: valid row x active subscriber
    (no compare kernel, no carried state)."""
    base = st.wlo * 32
    act = queries["active"][base:base + st.q_window]
    return dq.pack(tbl["_valid"][:, None] & (act & covered)[None])


def build_cycle(lowered: LoweredPlan, backend: OperatorBackend,
                device=None):
    """Returns cycle(storage, queries, updates) -> (storage', carry,
    results).

    queries: the packed admission batch —
             {"params": int32[qcap, P_max, 2], "active": bool[qcap]}
    updates: {table: update batch dict (see storage.empty_update_batch)}
    carry:   {"scan": {table: int32[T, whi-wlo]} window-local scan words
             of every predicated stage, "parts": {table: key partitions
             of every partitioned-join PK table}}
    results: per template row-id matrices / group top-k; all fixed
    shapes, plus "_overflow" (union-cap overflow count), "_join_rids"
    (the rid half of the carry) and "_parts_rebuilt".
    ``device=None`` builds the cycle for the CUDA card.
    """
    device = resolve_device(device)
    W = lowered.W
    apply_phase = _build_apply_phase(lowered)
    post_scan = _build_post_scan(lowered, backend, device)
    scan_covered, scan_pidx = _device_consts(lowered, device)

    def cycle(storage, queries, updates):
        storage, partitions, rebuilt = apply_phase(storage, updates)
        mark("apply")

        # shared scans (ClockScan): one pass per table for ALL queries,
        # each over its subscribers' word window
        scan_masks, scan_carry = {}, {}
        for st, covered, pidx in zip(lowered.scans, scan_covered,
                                     scan_pidx):
            tbl = storage[st.table]
            if not st.cols:
                m = _degenerate_scan(st, tbl, covered, queries)
            else:
                _, lo, hi = _bind_predicates(st, covered, pidx, queries)
                cols = torch.stack([tbl[c] for c in st.cols])
                m = backend.scan(cols, lo, hi, tbl["_valid"])
                scan_carry[st.table] = m
            scan_masks[st.table] = F.pad(m, (st.wlo, W - st.whi))
            mark(f"scan:{st.table}")

        carry = {"scan": scan_carry, "parts": partitions}
        results = post_scan(storage, partitions, scan_masks)
        results["_parts_rebuilt"] = rebuilt
        return storage, carry, results

    return cycle


def build_delta_cycle(lowered: LoweredPlan, backend: OperatorBackend,
                      delta_joins: bool = False, device=None):
    """Returns the incremental heartbeat:
    cycle(storage, carry, queries, updates) -> (storage', carry',
    results), or — with ``delta_joins=True`` —
    cycle(storage, carry, rid_carry, queries, updates).

    ``carry`` is the previous heartbeat's ``{"scan", "parts"}`` carry;
    ``queries`` additionally holds "changed": bool[qcap], the slots whose
    (active, params) differ from the previously dispatched heartbeat.
    Each predicated scan refreshes only its admission pane (the
    contiguous ``st.delta_words``-word range holding every changed slot,
    recomputed over all rows) and its table's dirty rows (re-evaluated
    against the full window), carrying every other (row, word) forward.
    With ``delta_joins=True`` every non-gather join re-probes only its
    spine's dirty rows and merges them into ``rid_carry`` (the previous
    heartbeat's ``results["_join_rids"]``).

    The executor guarantees eligibility host-side;
    ``results["_delta_overflow"]`` counts violations as a defensive
    invariant (0 on every eligible heartbeat).

    A backend's ``fused_delta`` op may merge into the carried scan words
    in place (the reference donates that carry half); the rid carry is
    never written in place, since it is also the previous heartbeat's
    in-flight ``results["_join_rids"]``.  ``device`` as for build_cycle.
    """
    device = resolve_device(device)
    cat = lowered.plan.catalog
    W = lowered.W
    apply_phase = _build_apply_phase(lowered)
    post_scan = _build_post_scan(lowered, backend, device)
    scan_covered, scan_pidx = _device_consts(lowered, device)
    carried_joins = [j for j in lowered.joins if j.kind != "gather"]
    carried_spines = sorted({j.spine for j in carried_joins})
    # the fused path: every predicated stage's pane + dirty rescan and
    # (with delta_joins) every carried join's dirty probe in ONE op
    fused = backend.fused_delta is not None

    def cycle(storage, carry, rid_carry, queries, updates):
        storage, partitions, rebuilt = apply_phase(storage, updates,
                                                   carry["parts"])
        mark("apply")
        changed = queries["changed"]

        scan_masks, new_carry = {}, {}
        delta_over = torch.zeros((), dtype=torch.int32, device=device)
        fused_scan_in, fused_stages = [], []
        panes, delta_in = [], []
        for st, covered, pidx in zip(lowered.scans, scan_covered,
                                     scan_pidx):
            tbl = storage[st.table]
            if not st.cols:
                # degenerate scans are recomputed, never carried
                m = _degenerate_scan(st, tbl, covered, queries)
                scan_masks[st.table] = F.pad(m, (st.wlo, W - st.whi))
                mark(f"scan:{st.table}")
                continue
            _, lo, hi = _bind_predicates(st, covered, pidx, queries)
            cols = torch.stack([tbl[c] for c in st.cols])
            A = st.delta_words
            T = cols.shape[1]

            span, w0, over = _pane_window(st, covered, changed)
            delta_over = delta_over + over
            pane_q = w0.long() * 32 + torch.arange(A * 32, device=device)
            lo_a = lo.index_select(1, pane_q)
            hi_a = hi.index_select(1, pane_q)
            dr = tbl["_dirty_rows"]
            delta_over = delta_over + tbl["_dirty_overflow"].to(torch.int32)
            if fused:
                fused_scan_in.append(FusedScanIn(
                    cols=cols, lo=lo, hi=hi, lo_p=lo_a, hi_p=hi_a,
                    valid=tbl["_valid"], carry=carry["scan"][st.table],
                    w0=w0, span=span, rows=dr, dn=tbl["_dirty_n"]))
                fused_stages.append(st)
                continue
            pane = backend.scan(cols, lo_a, hi_a, tbl["_valid"])
            at = (w0.long() + torch.arange(A, device=device)).expand(T, A)
            panes.append((st, carry["scan"][st.table].scatter(1, at, pane)))
            delta_in.append(DeltaScanIn(cols, lo, hi, tbl["_valid"], dr))
            mark(f"scan:{st.table}")

        # the chained path: every stage's dirty-row rescan in ONE op
        if delta_in:
            dwords = backend.scan_delta(tuple(delta_in))
            for (st, m), e, d in zip(panes, delta_in, dwords):
                m = scatter_dirty_rows(m, e.rows, d,
                                       cat.schemas[st.table].capacity)
                new_carry[st.table] = m
                scan_masks[st.table] = F.pad(m, (st.wlo, W - st.whi))
            mark("scan:delta")

        fused_join_in = []
        if delta_joins:
            # defensive: a carried join's spine dirty set must not have
            # overflowed either (the host checks the same thing exactly)
            for spine in carried_spines:
                delta_over = delta_over + \
                    storage[spine]["_dirty_overflow"].to(torch.int32)
            if fused:
                for j in carried_joins:
                    tbl = storage[j.spine]
                    if j.kind == "partitioned":
                        bkeys, brows, bounds = partitions[j.pk_table]
                    else:  # block: single-bucket pseudo-partitions
                        bkeys, brows, bounds = _pseudo_partitions(
                            storage[j.pk_table], j.pk_col)
                    fused_join_in.append(FusedJoinIn(
                        keys=tbl[j.fk_col], rows=tbl["_dirty_rows"],
                        dn=tbl["_dirty_n"], bkeys=bkeys, brows=brows,
                        bounds=bounds, rid_carry=rid_carry[j.key]))

        fused_rids = None
        if fused and (fused_scan_in or fused_join_in):
            words, rids = backend.fused_delta(tuple(fused_scan_in),
                                              tuple(fused_join_in))
            for st, m in zip(fused_stages, words):
                new_carry[st.table] = m
                scan_masks[st.table] = F.pad(m, (st.wlo, W - st.whi))
            if delta_joins:
                fused_rids = {j.key: r
                              for j, r in zip(carried_joins, rids)}
            mark("scan:fused")

        results = post_scan(storage, partitions, scan_masks,
                            rid_carry=rid_carry, fused_rids=fused_rids)
        results["_delta_overflow"] = delta_over
        results["_parts_rebuilt"] = rebuilt
        return storage, {"scan": new_carry, "parts": partitions}, results

    if delta_joins:
        return cycle
    # full-probe variant: same signature minus the rid carry
    return lambda storage, carry, queries, updates: cycle(
        storage, carry, None, queries, updates)


def _intersect_rids(m, rid, mask_r):
    """The join's query-set intersection from known rids:
    m & mask_r[rid] where matched, else 0."""
    gathered = mask_r[rid.long().clamp(0, mask_r.shape[0] - 1)]
    return torch.where((rid >= 0)[:, None], m & gathered, 0)


def _build_post_scan(lowered: LoweredPlan, backend: OperatorBackend,
                     device):
    """Joins, sorts, group-bys and routing (steps 3-6, shared by all
    cycle flavours; ``rid_carry`` switches the joins to the delta
    probe)."""
    plan = lowered.plan
    cat = plan.catalog

    def words(a):
        return upload(np.asarray(a, np.uint32).view(np.int32), device)

    limits = upload(lowered.limits, device)
    join_subs = [words(j.sub_mask) for j in lowered.joins]
    sort_subs = [words(s.sub_mask) for s in lowered.sorts]
    route_subs = [words(r.sub_mask) for r in lowered.routes]

    def post_scan(storage, partitions, scan_masks, rid_carry=None,
                  fused_rids=None):
        # 3. shared joins: ONE join per signature, query_id in the
        #    predicate via bitmask intersection; non-subscribers pass
        #    through untouched.  With carried rids only the spine's dirty
        #    rows are re-probed (or, with ``fused_rids``, the fused op
        #    already merged them); the intersection is always recomputed.
        spine_masks = dict(scan_masks)
        join_rids = {}
        # the chained path: every partitioned join's dirty-row probe in ONE
        # op, before the joins (a probe reads storage and partitions only)
        delta_rids = {}
        if rid_carry is not None and fused_rids is None:
            probed = [st for st in lowered.joins if st.kind == "partitioned"]
            if probed:
                rids = backend.join_delta(tuple(
                    DeltaJoinIn(storage[st.spine][st.fk_col],
                                storage[st.spine]["_dirty_rows"],
                                *partitions[st.pk_table]) for st in probed))
                delta_rids = {st.key: r for st, r in zip(probed, rids)}
                mark("join:delta")
        for st, sub in zip(lowered.joins, join_subs):
            tbl = storage[st.spine]
            m = spine_masks[st.spine]
            if st.kind == "gather":
                rid, combined = ops.shared_join_fk(
                    tbl[st.fk_col], m, storage[st.pk_table]["_pk_index"],
                    scan_masks[st.pk_table])
            elif fused_rids is not None:
                rid = fused_rids[st.key]
                combined = _intersect_rids(m, rid, scan_masks[st.pk_table])
            elif rid_carry is not None:
                cap = cat.schemas[st.spine].capacity
                dr = tbl["_dirty_rows"]
                if st.kind == "partitioned":
                    rid_d = delta_rids[st.key]
                else:  # block: dirty-row key-equality probe (tiny PK)
                    pk_tbl = storage[st.pk_table]
                    kd = tbl[st.fk_col][dr.long().clamp(0, cap - 1)]
                    rid_d = locate_rows_by_key(pk_tbl[st.pk_col], kd,
                                               pk_tbl["_valid"])
                rid = scatter_dirty_rows(rid_carry[st.key], dr, rid_d, cap)
                combined = _intersect_rids(m, rid, scan_masks[st.pk_table])
            elif st.kind == "partitioned":
                bkeys, brows, bounds = partitions[st.pk_table]
                rid, combined = backend.join_partitioned(
                    tbl[st.fk_col], m, bkeys, brows, bounds,
                    scan_masks[st.pk_table])
            else:  # block: dense key-equality kernel, small index-less PK
                pk_tbl = storage[st.pk_table]
                rid, combined = backend.join_block(
                    tbl[st.fk_col], m, pk_tbl[st.pk_col],
                    scan_masks[st.pk_table], pk_tbl["_valid"])
            spine_masks[st.spine] = (combined & sub[None, :]) \
                | (m & ~sub[None, :])
            join_rids[st.key] = rid
            mark("join:" + ".".join(st.key))

        # 4. shared sorts + fused per-query top-n + routing (Gamma) over
        #    the bounded UNION of wanted tuples (Fig. 4)
        results = {}
        overflow = torch.zeros((), dtype=torch.int32, device=device)
        for st, sub in zip(lowered.sorts, sort_subs):
            mask = spine_masks[st.spine][:, st.wlo:st.whi] & sub[None, :]
            rows_c, cmask, n_want = ops.compress_union(mask, st.union_cap)
            overflow = overflow + torch.clamp(n_want - st.union_cap, min=0)
            keys = storage[st.spine][st.col][rows_c.long().clamp(min=0)]
            keys = torch.where(rows_c >= 0, -keys if st.desc else keys,
                               ops.INT_MAX)
            perm = torch.sort(keys, stable=True).indices
            rows = ops.route_topn(cmask[perm],
                                  limits[st.wlo * 32:st.whi * 32],
                                  plan.max_results, rows=rows_c[perm])
            for name, o, c in st.slots:
                results[name] = {"rows": rows[o:o + c]}
            mark(f"sort:{st.spine}.{st.col}")

        # 5. shared group-bys (phase 1 shared over the union, phase 2 —
        #    the per-query top-k — as a stable sort, so ties break toward
        #    the lower group like ``jax.lax.top_k``)
        for st in lowered.groups:
            agg = st.agg
            tbl = storage[st.spine]
            rows_c, cmask, n_want = ops.compress_union(
                spine_masks[st.spine][:, st.wlo:st.whi], st.union_cap)
            overflow = overflow + torch.clamp(n_want - st.union_cap, min=0)
            safe = rows_c.long().clamp(min=0)
            gcodes = torch.where(rows_c >= 0, tbl[agg.group_col][safe], 0)
            gvals = torch.where(rows_c >= 0, tbl[agg.agg_col][safe], 0)
            count, ssum = backend.groupby(gcodes, gvals, cmask,
                                          agg.n_groups)
            score = ssum if agg.order_by == "sum" else count
            top_val, top_grp = ops.topk_stable(score.T, agg.top_k)
            top_cnt = torch.gather(count.T, 1, top_grp)
            for name, o, c in st.slots:
                results[name] = {
                    "groups": top_grp[o:o + c].to(torch.int32),
                    "scores": top_val[o:o + c],
                    "counts": top_cnt[o:o + c]}
            mark(f"groupby:{st.spine}")

        # 6. unsorted templates route in natural row order — ONE routing
        #    pass per spine shared by all such templates
        for st, sub in zip(lowered.routes, route_subs):
            mask = spine_masks[st.spine][:, st.wlo:st.whi] & sub[None, :]
            rows_c, cmask, n_want = ops.compress_union(mask, st.union_cap)
            overflow = overflow + torch.clamp(n_want - st.union_cap, min=0)
            rows = ops.route_topn(cmask, limits[st.wlo * 32:st.whi * 32],
                                  plan.max_results, rows=rows_c)
            for name, o, c in st.slots:
                results[name] = {"rows": rows[o:o + c]}
            mark(f"route:{st.spine}")
        results["_overflow"] = overflow
        results["_join_rids"] = join_rids
        return results

    return post_scan
