"""Mesh-sharded always-on plan: one heartbeat over several shards.

SharedDB scales shared operators by giving each one its own core (paper
§4.5); here the analogue is sharding the spine tables — and the
heartbeat carry itself — by spine-row range, so a full-rescan / reseed
beat spreads its bounded work over every shard while a steady-state
delta beat stays entirely shard-local.

The mesh is single-controller, as the reference's ``shard_map`` is: ONE
Python process drives every shard.  A ``RowMesh`` is an ordered tuple of
``torch.device``s (``make_row_mesh``), which may repeat a device — the
same card twice, or ``["cpu"] * 4`` in the tests.  Each shard's leaves
are tensors of their own on the shard's device even when the devices
repeat, so a read across shards happens only through the one collective
below, where the locality pass (``analysis_static.trace_passes``) can
see it.

Layout (the sharding contract):

  * ROW-SHARDED — every table that is NOT a join probe side.  Each
    shard holds its ``Ts = Tp // S`` rows of every column and of
    ``_valid`` (``Tp`` is the capacity rounded up to a multiple of S;
    padding rows stay invalid for good) and a PRIVATE dirty-row set of
    the rows it owns (local row ids, sentinel ``Ts``), so dirty rows
    route to their owning shard and the delta rescans / re-probes are
    per-shard gathers with no communication.  The carried scan words and
    per-join rids of these spines are ``[Ts]``-row per shard.
  * MIRRORED — every join PK-side table (the probe sides) is a full
    table dict on every shard, plus, per shard, a copy of the small side
    state of each row-sharded table: the append cursor ``_n``,
    ``_version``, the dense ``_pk_index`` (global row ids) and — for
    index-less PK tables — a (key, valid) mirror ``_mkey`` / ``_mvalid``
    so update targeting (``storage.locate_rows_by_key``) is a replicated
    computation instead of a cross-shard reduction.

Beat structure (``build_sharded_cycle`` / ``build_sharded_delta_cycle``):
the body is a Python loop over shard index ``i`` (``offset = i * Ts`` a
Python int), each shard's ops inside ``shard_scope(spec, i)``:

  * full / reseed beat — each shard scans its row slice of every
    mirrored predicated stage, and ONE ``all_gather_rows`` per such stage
    rebuilds the replicated words on every shard: the only collective in
    the system.  Row-sharded stages rescan shard-locally.
  * delta beat — the admission panes and dirty rows of mirrored tables
    refresh by replicated compute from each shard's mirror; row-sharded
    stages refresh from their private dirty sets and carried words /
    rids.  One ``fused_delta`` per shard (the chained ops without it).
    No collective.

Results: stages on mirrored spines run replicated and give final
per-template results (lowering's post-scan on the filtered plan); stages
on row-sharded spines give per-shard partials — route / sort candidates
with their comparison keys, group-by partial aggregates — that
``build_merge``'s device merge folds into final results (enqueued at
dispatch, behind the beat) and ``assemble`` hands to ``collect``.

``SharedDBEngine(mesh=...)`` threads all of this through the executor;
a 1-shard mesh is bit-identical to the unsharded engine: padded shapes
equal the originals, the shard body sees the full row range, and the
all_gather over one shard is a copy.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import dataquery as dq
from repro_torch.core import operators as ops
from repro_torch.core.backends import (DeltaJoinIn, DeltaScanIn,
                                       FusedJoinIn, FusedScanIn,
                                       OperatorBackend)
from repro_torch.core.device import resolve_device, upload
from repro_torch.core.lowering import (LoweredPlan, _bind_predicates,
                                       _build_post_scan, _intersect_rids,
                                       _pane_window, _pseudo_partitions)
from repro_torch.core.plan import CompiledPlan
from repro_torch.core.storage import (Catalog, TableSchema, _last_writer,
                                      _scatter_drop, _take, apply_updates,
                                      build_key_partitions, bulk_load,
                                      empty_table, locate_rows_by_key,
                                      nonzero_static,
                                      refresh_key_partitions,
                                      scatter_dirty_rows)

ROW_AXIS = "row"

# side-state keys of a row-sharded table (one copy per shard; everything
# else in the table dict is the shard's own row slice)
_SIDE_KEYS = ("_n", "_version", "_pk_index", "_mkey", "_mvalid")
# the shard's private dirty-row set (local row ids, sentinel Ts)
_STACKED_KEYS = ("_dirty_rows", "_dirty_n", "_dirty_overflow")


# ---------------------------------------------------------------------------
# The mesh and the layout
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RowMesh:
    """A 1-D row mesh: shard i runs on ``devices[i]``; devices may
    repeat."""
    devices: Tuple[torch.device, ...]
    axis: str = ROW_AXIS

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    @property
    def one_device(self) -> bool:
        return len(set(self.devices)) == 1


def _mesh_device(d) -> torch.device:
    d = resolve_device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_row_mesh(n_shards: int, devices: Optional[Sequence] = None
                  ) -> RowMesh:
    """A ``(n_shards,)`` row mesh.  ``devices=None``: the first
    ``n_shards`` CUDA devices (raises when there are fewer); otherwise
    one device per shard, repeats allowed (``["cpu"] * 4``, or one card
    twice)."""
    if n_shards < 1:
        raise ValueError(f"a row mesh needs at least one shard, got "
                         f"{n_shards}")
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_shards:
            raise RuntimeError(
                f"need {n_shards} CUDA devices for a {n_shards}-shard row "
                f"mesh, have {have}; pass devices= to place shards "
                f"yourself (one card repeated, or ['cpu'] * {n_shards})")
        devices = [torch.device("cuda", i) for i in range(n_shards)]
    devices = tuple(_mesh_device(d) for d in devices)
    if len(devices) != n_shards:
        raise ValueError(f"{len(devices)} devices for {n_shards} shards")
    return RowMesh(devices)


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """The sharding layout derived from (plan, mesh).

    ``mirrored`` — replicated tables (every join PK side).
    ``shard_rows``/``padded`` — per-table ``Ts`` and ``Tp = S * Ts``.
    ``commit_rows`` — the ORIGINAL capacities, the insert commit bound:
    rows in [commit_rows, padded) exist only for shard alignment and
    stay invalid for good, as the unsharded engine drops any insert
    landing there.  ``plan`` — the compiled plan with the PADDED catalog
    (at S=1 the original geometry exactly)."""
    mesh: RowMesh
    axis: str
    n_shards: int
    mirrored: Tuple[str, ...]
    shard_rows: Dict[str, int]
    padded: Dict[str, int]
    commit_rows: Dict[str, int]
    plan: CompiledPlan

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        return self.mesh.devices

    def is_mirrored(self, table: str) -> bool:
        return table in self.mirrored

    def schema(self, table: str) -> TableSchema:
        return self.plan.catalog.schemas[table]

    def rows(self, table: str) -> int:
        """Rows a shard holds of ``table``: the padded mirror or its
        slice."""
        return self.padded[table] if self.is_mirrored(table) \
            else self.shard_rows[table]


def build_shard_spec(plan: CompiledPlan, mesh: RowMesh) -> ShardSpec:
    S = mesh.n_shards
    mirrored = tuple(sorted({j.pk_table for j in plan.joins}))
    shard_rows, padded, commit_rows, schemas = {}, {}, {}, []
    for name, schema in plan.catalog.schemas.items():
        ts = -(-schema.capacity // S)
        shard_rows[name] = ts
        padded[name] = ts * S
        commit_rows[name] = schema.capacity
        schemas.append(dataclasses.replace(schema, capacity=ts * S))
    padded_plan = dataclasses.replace(plan, catalog=Catalog(schemas))
    return ShardSpec(mesh=mesh, axis=mesh.axis, n_shards=S,
                     mirrored=mirrored, shard_rows=shard_rows,
                     padded=padded, commit_rows=commit_rows,
                     plan=padded_plan)


def check_fold_mirrors(old_plan: CompiledPlan,
                       new_plan: CompiledPlan) -> None:
    """A fold under a mesh must keep the sharded STATE layout fixed.

    Whether a table is mirrored (a replicated probe side) or row-sharded
    is decided by join membership, and the two layouts hold different
    leaves: flipping a table would demand a cross-shard state migration
    mid-serve, and un-mirroring one would put collectives back into the
    delta beats its probes ride on.  The catalog is shared by
    construction (``extend_plan`` refuses new tables), so padded
    capacities never move; this check closes the remaining freedom.
    Folds that only subscribe to existing joins, or add joins into
    already-mirrored PK tables, pass.  The comparison is the planlint
    pass ``ir_passes.lint_fold_mirrors`` (``fold-mirror-set``); this
    raises ``ValueError`` naming the rule."""
    from repro_torch.analysis_static.diagnostics import raise_on_error
    from repro_torch.analysis_static.ir_passes import lint_fold_mirrors
    raise_on_error(lint_fold_mirrors(old_plan, new_plan), exc=ValueError)


# ---------------------------------------------------------------------------
# State construction
# ---------------------------------------------------------------------------


def init_sharded_state(spec: ShardSpec, initial_data: Dict) -> Tuple:
    """The padded, sharded initial state: a tuple of one state dict per
    shard, every leaf on the shard's device and of its own.

    Mirrored tables are full table dicts (padded capacity).  A row-
    sharded table holds the shard's ``[Ts]`` column and ``_valid``
    slices, its private dirty set and its copy of the side state (cursor,
    version, dense pk index, and the (key, valid) locate mirror of an
    index-less PK table — copies, never a column leaf)."""
    cpu = torch.device("cpu")
    out = []
    for i, dev in enumerate(spec.devices):
        state = {}
        for name, schema in spec.plan.catalog.schemas.items():
            data = initial_data.get(name)
            if spec.is_mirrored(name):
                state[name] = bulk_load(schema, data, dev) \
                    if data is not None else empty_table(schema, dev)
                continue
            Ts = spec.shard_rows[name]
            if data is None:
                # made on the device, no host copy: a fold's build makes
                # its scratch state on the fold thread, which must never
                # synchronise
                t = empty_table(dataclasses.replace(schema, capacity=Ts),
                                dev)
                if schema.pk and not schema.indexed:
                    t["_mkey"] = torch.zeros((schema.capacity,),
                                             dtype=torch.int32, device=dev)
                    t["_mvalid"] = torch.zeros((schema.capacity,),
                                               dtype=torch.bool, device=dev)
                state[name] = t
                continue
            full = bulk_load(schema, data, cpu)

            def own(t):
                return t.to(dev, copy=True)
            t = {c: own(full[c][i * Ts:(i + 1) * Ts])
                 for c in schema.columns}
            t["_valid"] = own(full["_valid"][i * Ts:(i + 1) * Ts])
            t["_dirty_rows"] = torch.full((schema.dirty_cap,), Ts,
                                          dtype=torch.int32, device=dev)
            t["_dirty_n"] = torch.zeros((), dtype=torch.int32, device=dev)
            t["_dirty_overflow"] = torch.zeros((), dtype=torch.bool,
                                               device=dev)
            t["_n"] = own(full["_n"])
            t["_version"] = own(full["_version"])
            if schema.indexed:
                t["_pk_index"] = own(full["_pk_index"])
            elif schema.pk:
                t["_mkey"] = own(full[schema.pk])
                t["_mvalid"] = own(full["_valid"])
            state[name] = t
        out.append(state)
    return tuple(out)


def _split_table(t: Dict) -> Tuple[Dict, Dict]:
    sh = {k: v for k, v in t.items() if k not in _SIDE_KEYS}
    side = {k: v for k, v in t.items() if k in _SIDE_KEYS}
    return sh, side


def host_table(spec: ShardSpec, state: Tuple, table: str
               ) -> Dict[str, np.ndarray]:
    """A table's columns and ``_valid`` on the host, in row order, at the
    ORIGINAL capacity, plus ``_n``: shard 0's replica of a mirrored
    table, the shards' slices concatenated for a row-sharded one."""
    schema = spec.schema(table)
    T = spec.commit_rows[table]
    keys = tuple(schema.columns) + ("_valid",)
    if spec.is_mirrored(table):
        parts = [state[0][table]]
    else:
        parts = [s[table] for s in state]
    out = {k: np.concatenate([p[k].to("cpu", copy=True).numpy()
                              for p in parts])[:T] for k in keys}
    out["_n"] = int(state[0][table]["_n"])
    return out


# ---------------------------------------------------------------------------
# Per-shard update apply
# ---------------------------------------------------------------------------


def _apply_shard(schema: TableSchema, spec: ShardSpec, local: Dict,
                 side: Dict, batch: Dict, offset: int):
    """One shard's slice of ``storage.apply_updates``.

    ``local`` holds this shard's ``[Ts]`` column slices and private dirty
    set, ``side`` its copy of the side state.  Row targeting reads only
    the side state (the dense pk index or the (key, valid) mirror), so
    every shard computes the same global rows and commits exactly the
    ones it owns — a replicated computation and a local scatter, never a
    cross-shard reduction; the side state is updated alike on every
    shard.  Field for field ``apply_updates``: deletes, then column
    updates located after the deletes, then inserts, in slot order; two
    slots writing one cell resolve to the later (``_last_writer``)."""
    Ts = spec.shard_rows[schema.name]
    Tp = spec.padded[schema.name]
    t, s = dict(local), dict(side)
    touched = []                      # LOCAL dirty candidates, -1 = no-op

    if schema.pk:
        def locate(keys, mask):
            """Global row holding pk ``keys[i]`` (-1 absent/masked)."""
            if schema.indexed:
                return torch.where(mask, _take(s["_pk_index"], keys), -1)
            return torch.where(
                mask, locate_rows_by_key(s["_mkey"], keys, s["_mvalid"]),
                -1)

        # deletes: invalidate owned rows; side bookkeeping on every shard
        del_g = locate(batch["del_key"], batch["del_mask"])
        ok = del_g >= 0
        dl = del_g - offset
        own = ok & (dl >= 0) & (dl < Ts)
        t["_valid"] = _scatter_drop(t["_valid"], torch.where(own, dl, Ts),
                                    False)
        touched.append(torch.where(own, dl, -1))
        if schema.indexed:
            s["_pk_index"] = _scatter_drop(
                s["_pk_index"],
                torch.where(ok, batch["del_key"], schema.key_space), -1)
        else:
            s["_mvalid"] = _scatter_drop(s["_mvalid"],
                                         torch.where(ok, del_g, Tp), False)

        # point updates, located after the deletes (arrival order)
        upd_g = locate(batch["upd_key"], batch["upd_mask"])
        ul = upd_g - offset
        uown = (upd_g >= 0) & (ul >= 0) & (ul < Ts)
        touched.append(torch.where(uown, ul, -1))
        for ci, c in enumerate(schema.columns):
            sel = _last_writer(ul, (batch["upd_col"] == ci) & uown)
            t[c] = _scatter_drop(t[c], torch.where(sel, ul, Ts),
                                 torch.where(sel, batch["upd_val"], 0))
        if not schema.indexed:
            # the locate mirror tracks the pk COLUMN, which updates may
            # rewrite, exactly like the column itself
            pk_ci = schema.columns.index(schema.pk)
            selk = _last_writer(upd_g, (batch["upd_col"] == pk_ci)
                                & (upd_g >= 0))
            s["_mkey"] = _scatter_drop(
                s["_mkey"], torch.where(selk, upd_g, Tp),
                torch.where(selk, batch["upd_val"], 0))

    # inserts: append at the replicated cursor, commit the owned rows.  The
    # commit bound is the ORIGINAL capacity: alignment rows stay invalid
    cap_c = spec.commit_rows[schema.name]
    ins = batch["ins_mask"]
    rows_g = torch.where(
        ins, s["_n"] + torch.cumsum(ins.to(torch.int32), 0,
                                    dtype=torch.int32) - 1, Tp)
    lands = ins & (rows_g < cap_c)
    rl = rows_g - offset
    lown = lands & (rl >= 0) & (rl < Ts)
    lrows = torch.where(lown, rl, Ts)
    for c in schema.columns:
        t[c] = _scatter_drop(t[c], lrows, batch["ins_rows"][c])
    t["_valid"] = _scatter_drop(t["_valid"], lrows, True)
    touched.append(torch.where(lown, rl, -1))
    s["_n"] = (s["_n"] + ins.sum()).to(torch.int32)
    if schema.indexed:
        keys = torch.where(ins, batch["ins_rows"][schema.pk],
                           schema.key_space)
        # a dropped insert indexes as absent, as in apply_updates
        s["_pk_index"] = _scatter_drop(
            s["_pk_index"],
            torch.where(_last_writer(keys, ins), keys, schema.key_space),
            torch.where(lands, rows_g, -1))
    elif schema.pk:
        irows = torch.where(lands, rows_g, Tp)
        s["_mkey"] = _scatter_drop(s["_mkey"], irows,
                                   batch["ins_rows"][schema.pk])
        s["_mvalid"] = _scatter_drop(s["_mvalid"], irows, True)
    s["_version"] = s["_version"] + 1

    # the private dirty set: the LOCAL rows this shard's slice was
    # touched at, ascending and distinct (a mark, then nonzero_static)
    cand = torch.cat([x.to(torch.int32) for x in touched])
    D = t["_dirty_rows"].shape[0]
    dev = ins.device
    mark = _scatter_drop(torch.zeros((Ts,), dtype=torch.bool, device=dev),
                         cand, True)
    count = mark.sum()
    t["_dirty_rows"] = nonzero_static(mark, D, Ts).to(torch.int32)
    t["_dirty_n"] = torch.clamp(count, max=D).to(torch.int32)
    t["_dirty_overflow"] = count > D
    return t, s


# ---------------------------------------------------------------------------
# Scan-stage helpers (shared by the mirrored and shard-local stages)
# ---------------------------------------------------------------------------


def _stage_full(st, backend, covered, pidx, tbl, queries):
    cols = torch.stack([tbl[c] for c in st.cols])
    _, lo, hi = _bind_predicates(st, covered, pidx, queries)
    return backend.scan(cols, lo, hi, tbl["_valid"])


def _stage_degenerate(st, covered, valid, queries):
    base = st.wlo * 32
    act = queries["active"][base:base + st.q_window]
    return dq.pack(valid[:, None] & (act & covered)[None])


def _fused_scan_in(st, covered, pidx, tbl, carry_words, queries):
    """One stage's ``FusedScanIn`` and overflow count: the predicate
    bind, the pane geometry (device-scalar offsets, ``_pane_window``) and
    the pane slices, over the rows the caller picks — a shard's mirror
    (its global dirty set) or a shard's slice (its private dirty set)."""
    _, lo, hi = _bind_predicates(st, covered, pidx, queries)
    cols = torch.stack([tbl[c] for c in st.cols])
    A = st.delta_words
    span, w0, over = _pane_window(st, covered, queries["changed"])
    pane_q = w0.long() * 32 + torch.arange(A * 32, device=cols.device)
    return FusedScanIn(
        cols=cols, lo=lo, hi=hi, lo_p=lo.index_select(1, pane_q),
        hi_p=hi.index_select(1, pane_q), valid=tbl["_valid"],
        carry=carry_words, w0=w0, span=span, rows=tbl["_dirty_rows"],
        dn=tbl["_dirty_n"]), \
        over + tbl["_dirty_overflow"].to(torch.int32)


def _stage_delta(st, backend, e: FusedScanIn):
    """The chained flavour of one stage: its admission pane merged into
    the carried words, and its dirty rows as a ``DeltaScanIn`` for the
    shard's one ``scan_delta`` call."""
    T = e.cols.shape[1]
    A = st.delta_words
    pane = backend.scan(e.cols, e.lo_p, e.hi_p, e.valid)
    at = (e.w0.long() + torch.arange(A, device=e.w0.device)).expand(T, A)
    return e.carry.scatter(1, at, pane), \
        DeltaScanIn(e.cols, e.lo, e.hi, e.valid, e.rows)


def _pad_words(st, m, W):
    return F.pad(m, (st.wlo, W - st.whi))


# ---------------------------------------------------------------------------
# The collective
# ---------------------------------------------------------------------------


@torch.library.custom_op("repro_torch::all_gather_rows", mutates_args=())
def all_gather_rows(parts: List[torch.Tensor]) -> List[torch.Tensor]:
    """The reseed beat's one collective: every shard's ``[Ts, w]`` words
    of a mirrored stage, concatenated in shard order into ``[S * Ts, w]``
    on each shard's own device (output i on ``parts[i]``'s device, a
    tensor of its own).  One op in a dispatch trace, captured into a
    graph like any other; counted in ``kernels.COLLECTIVES`` (a graph's
    capture records it, each replay adds it)."""
    from repro_torch import kernels
    kernels.count_collective("all_gather_rows")
    return [torch.cat([p.to(q.device) for p in parts]) for q in parts]


# the scope of the shard whose ops run now (the locality pass reads it)
_SCOPE = threading.local()


def current_shard() -> Optional[int]:
    """The shard index of the enclosing ``shard_scope``, else None."""
    return getattr(_SCOPE, "shard", None)


@contextlib.contextmanager
def shard_scope(spec: ShardSpec, i: int):
    """Run shard ``i``'s ops: marks them as shard ``i``'s and, on a mesh
    of distinct CUDA devices, makes its device current (a kernel launch
    goes to the current device)."""
    prev = current_shard()
    _SCOPE.shard = i
    dev = spec.devices[i]
    try:
        with (torch.cuda.device(dev)
              if dev.type == "cuda" and not spec.mesh.one_device
              else contextlib.nullcontext()):
            yield
    finally:
        _SCOPE.shard = prev


# ---------------------------------------------------------------------------
# The sharded heartbeat
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _ShardConsts:
    """One shard's device constants, uploaded when the cycle is built."""
    covered: Dict[str, torch.Tensor]
    pidx: Dict[str, torch.Tensor]
    join_subs: Dict[tuple, torch.Tensor]
    sort_subs: List[torch.Tensor]
    route_subs: List[torch.Tensor]
    limits: torch.Tensor
    mirror_post: object


def _words(a, device):
    return upload(np.asarray(a, np.uint32).view(np.int32), device)


def _build_impl(lowered: LoweredPlan, backend: OperatorBackend,
                spec: ShardSpec, delta: bool, delta_joins: bool):
    plan = spec.plan                       # padded catalog
    cat = plan.catalog
    W = lowered.W
    S = spec.n_shards
    mirrored = set(spec.mirrored)
    sharded_tables = [t for t in cat.schemas if t not in mirrored]
    sh_joins = [j for j in lowered.joins if j.spine not in mirrored]
    mi_joins = tuple(j for j in lowered.joins if j.spine in mirrored)
    sh_sorts = [s for s in lowered.sorts if s.spine not in mirrored]
    sh_groups = [g for g in lowered.groups if g.spine not in mirrored]
    sh_routes = [r for r in lowered.routes if r.spine not in mirrored]
    mi_pred = [st for st in lowered.scans
               if st.table in mirrored and st.cols]
    carried = [j for j in lowered.joins if j.kind != "gather"]
    carried_spines = sorted({j.spine for j in carried})
    # mirrored-spine post stages: lowering's post-scan on the filtered
    # (padded-catalog) plan, replicated compute on every shard
    filtered = dataclasses.replace(
        lowered, plan=plan, joins=mi_joins,
        sorts=tuple(s for s in lowered.sorts if s.spine in mirrored),
        groups=tuple(g for g in lowered.groups if g.spine in mirrored),
        routes=tuple(r for r in lowered.routes if r.spine in mirrored))
    # partitioned-join layouts over the PADDED mirror (the same
    # bucket_cap, the bucket count rounded up so padding rows fit; at S=1
    # the lowering's own), laid out by build_key_partitions
    part_specs = {}
    for j in lowered.joins:
        if j.kind == "partitioned":
            part_specs.setdefault(j.pk_table, (
                j.pk_col, -(-spec.padded[j.pk_table] // j.bucket_cap),
                j.bucket_cap))
    consts = []
    for dev in spec.devices:
        consts.append(_ShardConsts(
            covered={st.table: upload(st.covered, dev)
                     for st in lowered.scans},
            pidx={st.table: upload(st.param_idx, dev, torch.int64)
                  for st in lowered.scans},
            join_subs={j.key: _words(j.sub_mask, dev) for j in sh_joins},
            sort_subs=[_words(s.sub_mask, dev) for s in sh_sorts],
            route_subs=[_words(r.sub_mask, dev) for r in sh_routes],
            limits=upload(lowered.limits, dev),
            mirror_post=_build_post_scan(filtered, backend, dev)))
    # the fused delta beat: every pane, dirty rescan and dirty probe of a
    # shard — over its mirrors AND its slices — in ONE op per shard (a
    # backend without fused_delta keeps the chained ops)
    fused = delta and backend.fused_delta is not None
    delta_probe = delta and delta_joins

    def front(i, state, carry, rid_carry, queries, updates):
        """Update apply, partitions, scans (and in a delta beat the
        shard's one fused op, or its chained ops)."""
        c = consts[i]
        dev = spec.devices[i]
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        mirror = {t: apply_updates(cat.schemas[t], state[t], updates[t],
                                   commit_cap=spec.commit_rows[t])
                  for t in spec.mirrored}
        tables, sides = {}, {}
        for t in sharded_tables:
            local, side = _split_table(state[t])
            tables[t], sides[t] = _apply_shard(
                cat.schemas[t], spec, local, side, updates[t],
                i * spec.shard_rows[t])

        def tbl_of(t):
            return mirror[t] if t in mirrored else tables[t]

        partitions, rebuilt = {}, {}
        for t, (pk_col, n_parts, bucket_cap) in part_specs.items():
            m = mirror[t]
            if delta:
                partitions[t], rebuilt[t] = refresh_key_partitions(
                    m, pk_col, n_parts, bucket_cap, carry["parts"][t])
            else:
                partitions[t] = build_key_partitions(
                    m[pk_col], m["_valid"], n_parts, bucket_cap)
                rebuilt[t] = torch.ones((), dtype=torch.bool, device=dev)

        words, panes = {}, {}
        dover = {"repl": zero, "local": zero}
        fused_scan, fused_stages, chained, delta_in = [], [], [], []
        for st in lowered.scans:
            mi = st.table in mirrored
            tbl = tbl_of(st.table)
            cov, pidx = c.covered[st.table], c.pidx[st.table]
            if not st.cols:
                words[st.table] = _stage_degenerate(st, cov, tbl["_valid"],
                                                    queries)
            elif not delta and mi:
                # reseed: this shard scans its row SLICE of the mirror;
                # the all_gather rebuilds the replicated words
                Ts = spec.shard_rows[st.table]
                sl = {k: tbl[k][i * Ts:(i + 1) * Ts]
                      for k in st.cols + ("_valid",)}
                panes[st.table] = _stage_full(st, backend, cov, pidx, sl,
                                              queries)
            elif not delta:
                words[st.table] = _stage_full(st, backend, cov, pidx, tbl,
                                              queries)
            else:
                e, over = _fused_scan_in(st, cov, pidx, tbl,
                                         carry["scan"][st.table], queries)
                side = "repl" if mi else "local"
                dover[side] = dover[side] + over
                if fused:
                    fused_scan.append(e)
                    fused_stages.append(st)
                else:
                    m, d = _stage_delta(st, backend, e)
                    chained.append((st, m))
                    delta_in.append(d)
        if delta_in:
            # the chained flavour: every stage's dirty rescan in ONE op
            for (st, m), e, d in zip(chained, delta_in,
                                     backend.scan_delta(tuple(delta_in))):
                words[st.table] = scatter_dirty_rows(m, e.rows, d,
                                                     spec.rows(st.table))

        known_rids = {}
        if delta_probe:
            for spine in carried_spines:
                side = "repl" if spine in mirrored else "local"
                dover[side] = dover[side] + \
                    tbl_of(spine)["_dirty_overflow"].to(torch.int32)
        fused_join = []
        if fused and delta_probe:
            for j in carried:
                tbl = tbl_of(j.spine)
                if j.kind == "partitioned":
                    bkeys, brows, bounds = partitions[j.pk_table]
                else:        # block: single-bucket pseudo-partitions
                    bkeys, brows, bounds = _pseudo_partitions(
                        mirror[j.pk_table], j.pk_col)
                fused_join.append(FusedJoinIn(
                    keys=tbl[j.fk_col], rows=tbl["_dirty_rows"],
                    dn=tbl["_dirty_n"], bkeys=bkeys, brows=brows,
                    bounds=bounds, rid_carry=rid_carry[j.key]))
        if fused and (fused_scan or fused_join):
            out_words, out_rids = backend.fused_delta(tuple(fused_scan),
                                                      tuple(fused_join))
            for st, m in zip(fused_stages, out_words):
                words[st.table] = m
            if delta_probe:
                known_rids = {j.key: r for j, r in zip(carried, out_rids)}
        elif delta_probe:
            # the chained flavour: every partitioned join's dirty probe in
            # ONE op, block joins by key-equality on the dirty rows
            probed = [j for j in carried if j.kind == "partitioned"]
            rid_d = {}
            if probed:
                got = backend.join_delta(tuple(
                    DeltaJoinIn(tbl_of(j.spine)[j.fk_col],
                                tbl_of(j.spine)["_dirty_rows"],
                                *partitions[j.pk_table]) for j in probed))
                rid_d = {j.key: r for j, r in zip(probed, got)}
            for j in carried:
                tbl = tbl_of(j.spine)
                cap = spec.rows(j.spine)
                dr = tbl["_dirty_rows"]
                if j.key not in rid_d:
                    pk = mirror[j.pk_table]
                    kd = tbl[j.fk_col][dr.long().clamp(0, cap - 1)]
                    rid_d[j.key] = locate_rows_by_key(pk[j.pk_col], kd,
                                                      pk["_valid"])
                known_rids[j.key] = scatter_dirty_rows(
                    rid_carry[j.key], dr, rid_d[j.key], cap)
        return dict(mirror=mirror, tables=tables, sides=sides,
                    partitions=partitions, rebuilt=rebuilt, words=words,
                    panes=panes, dover=dover, known_rids=known_rids)

    def back(i, f, gathered):
        """Joins, partials and the mirrored-spine post stages."""
        c = consts[i]
        dev = spec.devices[i]
        mirror, tables = f["mirror"], f["tables"]
        partitions, words = f["partitions"], dict(f["words"])
        words.update(gathered)
        masks = {st.table: _pad_words(st, words[st.table], W)
                 for st in lowered.scans}
        known = f["known_rids"]

        # joins on row-sharded spines (probe sides mirrored: partitions,
        # pk index and words are the shard's own — shard-local math)
        spine_masks = dict(masks)
        sh_rids = {}
        for j in sh_joins:
            tbl = tables[j.spine]
            m = spine_masks[j.spine]
            mask_r = masks[j.pk_table]
            pk = mirror[j.pk_table]
            if j.kind == "gather":
                rid, combined = ops.shared_join_fk(
                    tbl[j.fk_col], m, pk["_pk_index"], mask_r)
            elif delta_probe:
                rid = known[j.key]
                combined = _intersect_rids(m, rid, mask_r)
            elif j.kind == "partitioned":
                rid, combined = backend.join_partitioned(
                    tbl[j.fk_col], m, *partitions[j.pk_table], mask_r)
            else:
                rid, combined = backend.join_block(
                    tbl[j.fk_col], m, pk[j.pk_col], mask_r, pk["_valid"])
            sub = c.join_subs[j.key]
            spine_masks[j.spine] = (combined & sub[None, :]) \
                | (m & ~sub[None, :])
            sh_rids[j.key] = rid

        # per-shard partials of row-sharded sort / group / route stages
        partials = {}
        over_local = torch.zeros((), dtype=torch.int32, device=dev)
        for st, sub in zip(sh_sorts, c.sort_subs):
            Ts = spec.shard_rows[st.spine]
            mask = spine_masks[st.spine][:, st.wlo:st.whi] & sub[None, :]
            rows_c, cmask, n_want = ops.compress_union(mask, st.union_cap)
            over_local = over_local + torch.clamp(n_want - st.union_cap,
                                                  min=0)
            col = tables[st.spine][st.col]
            keys = col[rows_c.long().clamp(min=0)]
            keys = torch.where(rows_c >= 0, -keys if st.desc else keys,
                               ops.INT_MAX)
            perm = torch.sort(keys, stable=True).indices
            rows = ops.route_topn(cmask[perm],
                                  c.limits[st.wlo * 32:st.whi * 32],
                                  plan.max_results, rows=rows_c[perm])
            ksel = col[rows.long().clamp(0, Ts - 1)]
            kcmp = torch.where(rows >= 0, -ksel if st.desc else ksel,
                               ops.INT_MAX)
            rows_g = torch.where(rows >= 0, rows + i * Ts, -1)
            for name, o, n in st.slots:
                partials[name] = {"rows": rows_g[o:o + n],
                                  "keys": kcmp[o:o + n]}
        for st in sh_groups:
            agg = st.agg
            tbl = tables[st.spine]
            rows_c, cmask, n_want = ops.compress_union(
                spine_masks[st.spine][:, st.wlo:st.whi], st.union_cap)
            over_local = over_local + torch.clamp(n_want - st.union_cap,
                                                  min=0)
            safe = rows_c.long().clamp(min=0)
            gcodes = torch.where(rows_c >= 0, tbl[agg.group_col][safe], 0)
            gvals = torch.where(rows_c >= 0, tbl[agg.agg_col][safe], 0)
            count, ssum = backend.groupby(gcodes, gvals, cmask,
                                          agg.n_groups)
            partials[_group_key(st)] = {"count": count, "sum": ssum}
        for st, sub in zip(sh_routes, c.route_subs):
            mask = spine_masks[st.spine][:, st.wlo:st.whi] & sub[None, :]
            rows_c, cmask, n_want = ops.compress_union(mask, st.union_cap)
            over_local = over_local + torch.clamp(n_want - st.union_cap,
                                                  min=0)
            rows = ops.route_topn(cmask, c.limits[st.wlo * 32:st.whi * 32],
                                  plan.max_results, rows=rows_c)
            rows_g = torch.where(rows >= 0,
                                 rows + i * spec.shard_rows[st.spine], -1)
            for name, o, n in st.slots:
                partials[name] = {"rows": rows_g[o:o + n]}

        # mirrored-spine post stages: replicated, final results
        mi_masks = {t: m for t, m in masks.items() if t in mirrored}
        if delta_probe:
            mi_known = {j.key: known[j.key] for j in mi_joins
                        if j.kind != "gather"}
            results = c.mirror_post(dict(mirror), partitions, mi_masks,
                                    fused_rids=mi_known)
        else:
            results = c.mirror_post(dict(mirror), partitions, mi_masks)
        rids = {**results.pop("_join_rids"), **sh_rids}
        over_repl = results.pop("_overflow")
        state = {t: mirror[t] for t in spec.mirrored}
        for t in sharded_tables:
            state[t] = {**tables[t], **f["sides"][t]}
        carry = {"scan": {st.table: words[st.table] for st in lowered.scans
                          if st.cols},
                 "parts": partitions}
        shard = {"results": results, "partials": partials,
                 "over_repl": over_repl, "over_local": over_local,
                 "dover_repl": f["dover"]["repl"],
                 "dover_local": f["dover"]["local"],
                 "rebuilt": f["rebuilt"]}
        return state, carry, rids, shard

    def cycle(state, carry, rid_carry, queries, updates):
        fronts = []
        for i in range(S):
            with shard_scope(spec, i):
                fronts.append(front(
                    i, state[i], carry[i] if delta else None,
                    rid_carry[i] if delta_probe else None, queries[i],
                    updates[i]))
        gathered = [{} for _ in range(S)]
        for st in mi_pred:
            if delta:
                break
            outs = torch.ops.repro_torch.all_gather_rows(
                [f["panes"][st.table] for f in fronts])
            for g, o in zip(gathered, outs):
                g[st.table] = o
        outs = []
        for i in range(S):
            with shard_scope(spec, i):
                outs.append(back(i, fronts[i], gathered[i]))
        state_out, carry_out, rids, shards = zip(*outs)
        return state_out, carry_out, {"_join_rids": rids, "_shard": shards}

    if not delta:
        return lambda state, queries, updates: cycle(
            state, None, None, queries, updates)
    if delta_joins:
        return cycle
    return lambda state, carry, queries, updates: cycle(
        state, carry, None, queries, updates)


def _group_key(st) -> str:
    return f"group:{st.spine}:{st.agg.group_col}:{st.agg.agg_col}"


def build_sharded_cycle(lowered: LoweredPlan, backend: OperatorBackend,
                        spec: ShardSpec):
    """Full-rescan / reseed heartbeat over the mesh:
    cycle(state, queries, updates) -> (state', carry, results), every
    argument a tuple of one tree per shard (``results``: per-shard
    ``_join_rids`` and ``_shard`` outputs for ``build_merge``).  Each
    shard rescans its own rows once; the mirrored stages re-assemble
    through one ``all_gather_rows`` per stage."""
    return _build_impl(lowered, backend, spec, delta=False,
                       delta_joins=False)


def build_sharded_delta_cycle(lowered: LoweredPlan,
                              backend: OperatorBackend, spec: ShardSpec,
                              delta_joins: bool = False):
    """Incremental heartbeat over the mesh, entirely shard-local:
    cycle(state, carry, queries, updates), or with ``delta_joins=True``
    cycle(state, carry, rid_carry, queries, updates).  Dirty rows route
    to their owning shard (the private dirty sets of the update apply),
    admission panes refresh per shard (replicated for the mirrors), and
    carried rids merge shard-locally; no collective."""
    return _build_impl(lowered, backend, spec, delta=True,
                       delta_joins=delta_joins)


def fused_geometry(lowered: LoweredPlan, spec: ShardSpec):
    """The geometry of one shard's ``fused_delta`` call in a delta-join
    beat (``kernel_passes.FusedGeometry``): the lowering's stages and
    carried joins in order, each over the rows a shard holds — a
    mirror's padded capacity, a row-sharded table's ``Ts``."""
    from repro_torch.analysis_static.kernel_passes import \
        geometry_from_lowered
    cat = spec.plan.catalog
    schemas = [dataclasses.replace(s, capacity=spec.rows(name))
               for name, s in cat.schemas.items()]
    shard_plan = dataclasses.replace(spec.plan, catalog=Catalog(schemas))
    joins = tuple(dataclasses.replace(
        j, n_partitions=-(-spec.padded[j.pk_table] // j.bucket_cap))
        if j.kind == "partitioned" else j for j in lowered.joins)
    return geometry_from_lowered(dataclasses.replace(
        lowered, plan=shard_plan, joins=joins))


# ---------------------------------------------------------------------------
# The cross-shard merge
# ---------------------------------------------------------------------------


def _merge_ordered(rows, keys, lim, R: int):
    """rows / keys [S, c, R] per-shard candidates (prefix-filled, -1
    padded, each in key order), lim int32[c] -> [c, R]: the first
    ``lim`` rows per slot in global key order, -1 padded.  Stable: equal
    keys resolve in shard order, which is global row order."""
    c = rows.shape[1]
    flat_r = rows.permute(1, 0, 2).reshape(c, -1)
    flat_k = keys.permute(1, 0, 2).reshape(c, -1)
    order = torch.sort(flat_k, dim=1, stable=True).indices
    cand = torch.gather(flat_r, 1, order)
    valid = cand >= 0
    pos = torch.cumsum(valid.to(torch.int32), 1, dtype=torch.int32) - 1
    keep = valid & (pos < lim[:, None])
    out = torch.full((c, R + 1), -1, dtype=torch.int32, device=rows.device)
    out.scatter_(1, torch.where(keep, pos, R).long(),
                 torch.where(keep, cand, -1))
    return out[:, :R]


def build_merge(lowered: LoweredPlan, spec: ShardSpec):
    """Cross-shard result routing: ``(device_merge, assemble)``.

    ``device_merge(shards)`` runs on the device, on shard 0's: row-
    sharded route / sort templates merge their per-shard candidate lists
    with one stable sort per template — shard order IS global row order,
    so a stable sort on the comparison keys reproduces the unsharded sort
    exactly — and group templates sum the per-shard partial aggregates
    before a device top-k.  The executor enqueues it behind the beat, at
    dispatch.  ``assemble(results)`` is the host epilogue of ``collect``:
    the mirrored templates' (final) results from shard 0, the merged
    ones, and the overflow counts summed.  At S=1 every merge is the
    identity."""
    mirrored = set(spec.mirrored)
    R = spec.plan.max_results
    dev0 = spec.devices[0]
    sort_tpl, route_tpl, group_tpl, lims = set(), set(), {}, {}
    for stages, into in ((lowered.sorts, sort_tpl),
                         (lowered.routes, route_tpl)):
        for st in stages:
            if st.spine in mirrored:
                continue
            base = st.wlo * 32
            for name, o, c in st.slots:
                into.add(name)
                lims[name] = upload(np.minimum(
                    lowered.limits[base + o:base + o + c],
                    R).astype(np.int32), dev0)
    for st in lowered.groups:
        if st.spine not in mirrored:
            for name, o, c in st.slots:
                group_tpl[name] = (st, o, c)

    def device_merge(shards) -> Dict:
        def parts(name, key):
            return torch.stack([s["partials"][name][key].to(dev0)
                                for s in shards])
        merged = {}
        for name in sort_tpl:
            merged[name] = {"rows": _merge_ordered(
                parts(name, "rows"), parts(name, "keys"), lims[name], R)}
        for name in route_tpl:
            rows = parts(name, "rows")
            # natural order == global row order: merge on the row id
            keys = torch.where(rows >= 0, rows, ops.INT_MAX)
            merged[name] = {"rows": _merge_ordered(rows, keys, lims[name],
                                                   R)}
        totals = {}
        for name, (st, o, c) in group_tpl.items():
            gkey = _group_key(st)
            if gkey not in totals:
                totals[gkey] = {k: functools.reduce(
                    torch.add, [s["partials"][gkey][k].to(dev0)
                                for s in shards]) for k in ("count", "sum")}
            count = totals[gkey]["count"]
            score = totals[gkey]["sum"] if st.agg.order_by == "sum" \
                else count
            top_val, top_grp = ops.topk_stable(score[:, o:o + c].T,
                                               st.agg.top_k)
            merged[name] = {
                "groups": top_grp.to(torch.int32), "scores": top_val,
                "counts": torch.gather(count[:, o:o + c].T, 1, top_grp)}
        return merged

    def assemble(results) -> Dict:
        shards = results["_shard"]
        out = {name: (results["_merged"][name] if name in results["_merged"]
                      else shards[0]["results"][name])
               for name in spec.plan.templates}
        out["_overflow"] = int(shards[0]["over_repl"]) + sum(
            int(s["over_local"]) for s in shards)
        out["_delta_overflow"] = int(shards[0]["dover_repl"]) + sum(
            int(s["dover_local"]) for s in shards)
        out["_parts_rebuilt"] = shards[0]["rebuilt"]
        return out

    return device_merge, assemble


def migrate_carry(old: LoweredPlan, new: LoweredPlan, carry, rid_carry):
    """``folding.migrate_carry`` fed per shard: ``(carry', rid_carry')``
    as tuples of one tree per shard, either ``None`` when it must be
    re-seeded."""
    from repro_torch.core import folding
    S = len(carry) if carry is not None else len(rid_carry or ())
    got = [folding.migrate_carry(
        old, new, None if carry is None else carry[i],
        None if rid_carry is None else rid_carry[i]) for i in range(S)]
    carries = tuple(g[0] for g in got)
    rids = tuple(g[1] for g in got)
    return (None if not got or any(c is None for c in carries) else carries,
            None if not got or any(r is None for r in rids) else rids)
