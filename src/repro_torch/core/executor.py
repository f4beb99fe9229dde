"""Heartbeat executor (paper §3.2, §4.2, Algorithm 1) — pipelined, on one
device.

While one batch of queries and updates executes, newly arriving work
queues; at each heartbeat the queues are drained (up to the per-template
slot capacity — excess stays queued, the paper's admission rule) and
pushed through ONE heartbeat of the global plan.

The heartbeat is split so host and device overlap:

  dispatch() — drain the queues into PREALLOCATED pinned staging buffers,
               copy them to the device (one asynchronous copy per packed
               buffer) and enqueue the cycle's kernels on the current
               stream.  Nothing in it waits for the device.
  collect()  — wait for the oldest in-flight heartbeat and route its
               results to the waiting tickets.

With double-buffered admission (pipeline depth 2) the queue draining and
parameter staging for heartbeat N+1 overlap device execution of N; a
staging buffer is reused only after the heartbeat that read it was
collected.

Scans AND joins are incremental: every heartbeat returns a carry (scan
words + key partitions) and exposes each join's rids in
``results["_join_rids"]``, which the executor threads forward as the rid
half of the carry.  The next dispatch runs a DELTA cycle when the carry
exists and the heartbeat's deltas fit their fixed capacities, and its
``delta_joins`` variant when additionally no carried join's PK table was
touched; every choice is made host-side from exact admission knowledge.
The scan-word carry may be merged into in place (the reference donates
it); the rid carry is never written in place, because its tensors are
also the previous heartbeat's in-flight ``results["_join_rids"]``.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.backends import counting_backend, resolve_backend
from repro_torch.core.device import resolve_device
from repro_torch.core.lowering import (PARTITIONED_MIN_CAPACITY, build_cycle,
                                       build_delta_cycle, lower_plan)
from repro_torch.core.plan import CompiledPlan
from repro_torch.core.storage import (UPDATE_BATCH_RESET, UpdateSlots,
                                      empty_update_batch)


def check_carry_layout(carry_token, layout_token) -> None:
    """Always-on carry/layout guard (deliberately NOT an assert): a delta
    heartbeat must never consume a carry produced under a different
    admission layout — the carried words/rids are positional in it."""
    if carry_token != layout_token:
        raise RuntimeError(
            "delta heartbeat would consume a carry produced under a "
            "different admission layout — reset the carries "
            f"(carry {carry_token} != plan {layout_token})")


def _measure_key_stats(plan: CompiledPlan,
                       initial_data) -> Dict[str, Dict[str, int]]:
    """Measured key skew of every partitioned-join candidate PK table
    (index-less, at or above the partitioned threshold), from the initial
    snapshot: live-row count and widest duplicate-key run."""
    stats = {}
    for t, schema in plan.catalog.schemas.items():
        if (schema.pk is None or schema.key_space > 0
                or schema.capacity < PARTITIONED_MIN_CAPACITY):
            continue
        data = (initial_data or {}).get(t, {})
        keys = np.asarray(data.get(schema.pk, ()))
        if keys.size:
            _, counts = np.unique(keys, return_counts=True)
            stats[t] = {"n_live": int(keys.size),
                        "max_dup": int(counts.max())}
        else:
            stats[t] = {"n_live": 0, "max_dup": 1}
    return stats


def _clear_counts_at_entry(fn, counts: Dict[str, int]):
    """Reset a flavour's backend-op counter at cycle entry, so the counts
    are the backend launches of the beat that ran last."""
    def wrapped(*args):
        counts.clear()
        return fn(*args)
    return wrapped


@dataclasses.dataclass
class Ticket:
    id: int
    template: str
    params: Any
    submit_time: float
    done_time: Optional[float] = None
    result: Any = None

    @property
    def latency(self) -> float:
        return (self.done_time - self.submit_time) if self.done_time else None


class _StagingBuffers:
    """Preallocated host-side admission buffers for ONE pipeline slot.

    Every field of a heartbeat's admission — the packed [qcap, P_max, 2]
    parameters, the active and changed slot vectors, and every table's
    update batch (storage.empty_update_batch's layout) — is a numpy view
    into one of TWO flat host buffers, int32 and uint8 (the bools), held
    in pinned memory when the device is CUDA.  Staging a heartbeat is
    then two asynchronous host-to-device copies, whatever the template
    and table counts, and the device tree is views into the two copies.
    """

    def __init__(self, plan: CompiledPlan, slots: UpdateSlots,
                 device: torch.device):
        self.device = device
        layout = {
            "params": np.zeros((plan.qcap, plan.n_params_max, 2), np.int32),
            "active": np.zeros((plan.qcap,), bool),
            # per-slot changed vector of the delta path: double-buffered
            # with the rest, an in-flight copy must never see a rewrite
            "changed": np.zeros((plan.qcap,), bool),
            "updates": {t: empty_update_batch(schema, slots, xp=np)
                        for t, schema in plan.catalog.schemas.items()}}
        self._fields = []        # (path, is_bool, offset, size, shape)
        size = {False: 0, True: 0}

        def walk(tree, path):
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(v, path + (k,))
                else:
                    b = v.dtype == np.bool_
                    self._fields.append((path + (k,), b, size[b], v.size,
                                         v.shape))
                    size[b] += v.size
        walk(layout, ())
        pin = device.type == "cuda"
        self._i32 = torch.zeros(size[False], dtype=torch.int32,
                                pin_memory=pin)
        self._u8 = torch.zeros(size[True], dtype=torch.uint8, pin_memory=pin)
        i32, u8 = self._i32.numpy(), self._u8.numpy().view(np.bool_)
        views = {}
        for path, b, off, n, shape in self._fields:
            src = layout
            for k in path:
                src = src[k]
            view = (u8 if b else i32)[off:off + n].reshape(shape)
            view[...] = src
            self._put(views, path, view)
        self.params = views["params"]
        self.active = views["active"]
        self.changed = views["changed"]
        self.updates = views["updates"]

    @staticmethod
    def _put(tree, path, leaf):
        for k in path[:-1]:
            tree = tree.setdefault(k, {})
        tree[path[-1]] = leaf

    def reset(self) -> None:
        self.active[:] = False
        for b in self.updates.values():
            for field, fill in UPDATE_BATCH_RESET.items():
                b[field][:] = fill

    def stage(self) -> Dict:
        """The whole admission on the device: two copies, then views."""
        if self.device.type == "cuda":
            i32 = self._i32.to(self.device, non_blocking=True)
            u8 = self._u8.to(self.device, non_blocking=True)
        else:
            i32, u8 = self._i32.clone(), self._u8.clone()
        out = {}
        for path, b, off, n, shape in self._fields:
            leaf = u8[off:off + n].view(torch.bool) if b \
                else i32[off:off + n]
            self._put(out, path, leaf.view(shape))
        return out


@dataclasses.dataclass
class CycleResult:
    """One collected heartbeat: routed tickets + its observed wall time.

    ``wall_s`` is the collector-side inter-completion time; ``admitted``
    / ``dirty`` count the queries and update-touched rows the heartbeat
    carried; ``scan_path`` / ``join_path`` name the flavours it ran
    ("delta", "full", "mixed" when backpressure folded several heartbeats
    into one collect, "" for no carried joins).  The ``t_*_s`` fields
    are the host-time breakdown — staging (queue drain + buffer fill +
    copies enqueued), dispatch (the cycle's kernels enqueued), kernel
    (the collect-side wait for the device) and collect (result copy +
    ticket routing) — and ``backend_ops`` the beat's backend launches."""
    tickets: Dict[str, List[Ticket]]
    wall_s: float
    admitted: int = 0
    dirty: int = 0
    scan_path: str = ""
    join_path: str = ""
    t_stage_s: float = 0.0
    t_dispatch_s: float = 0.0
    t_kernel_s: float = 0.0
    t_collect_s: float = 0.0
    backend_ops: Dict[str, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class _InFlight:
    """One dispatched-but-not-collected heartbeat."""
    admitted: Dict[str, List[Ticket]]
    results: Any
    done: Any = None            # CUDA event recorded behind the cycle
    n_admitted: int = 0
    n_dirty: int = 0
    scan_path: str = "full"
    join_path: str = ""
    t_stage_s: float = 0.0
    t_dispatch_s: float = 0.0
    t_kernel_s: float = 0.0
    t_collect_s: float = 0.0
    backend_ops: Dict[str, int] = dataclasses.field(default_factory=dict)


class SharedDBEngine:
    """The always-on global plan + admission queues, on one device."""

    def __init__(self, plan: CompiledPlan, update_slots: UpdateSlots,
                 initial_data: Dict[str, Dict[str, np.ndarray]],
                 kernels: str = "auto", device=None,
                 pipeline_depth: int = 2):
        """``device=None`` runs on the CUDA card and raises when there is
        none; ``device="cpu"`` runs the plain PyTorch path.  ``kernels``:
        "auto" (``hopper`` on a card of capability 9.0+, ``torch`` on the
        CPU), "torch", "hopper" or another registered backend name."""
        self.device = resolve_device(device)
        self.plan = plan
        self.update_slots = update_slots
        self._queues: Dict[str, collections.deque] = {
            name: collections.deque() for name in plan.templates}
        self._update_queue: collections.deque = collections.deque()
        self._ticket_ids = itertools.count()
        self._backend = resolve_backend(kernels, self.device)
        self._key_stats = _measure_key_stats(plan, initial_data)
        self._build_cycles()
        self.state = plan.catalog.init_state(initial_data, self.device)
        self._carry = None           # previous heartbeat's scan words +
        #                              key partitions
        self._rid_carry = None       # previous heartbeat's join rids
        self._carry_token = None
        # (active, params) of the last DISPATCHED heartbeat: the delta
        # path diffs against these to find changed admission slots
        self._prev_params = np.zeros((plan.qcap, plan.n_params_max, 2),
                                     np.int32)
        self._prev_active = np.zeros((plan.qcap,), bool)
        self.pipeline_depth = max(1, pipeline_depth)
        self._staging = [_StagingBuffers(plan, update_slots, self.device)
                         for _ in range(self.pipeline_depth)]
        self._staging_idx = 0
        self._inflight: collections.deque[_InFlight] = collections.deque()
        # routing from backpressure collects inside dispatch(), surfaced
        # by the next public collect()
        self._spilled: Dict[str, List[Ticket]] = {}
        self._spilled_stats: List[_InFlight] = []
        self.cycles_run = 0
        self.queries_done = 0
        self.last_overflow = 0    # union-cap overflow of the last collect
        self.delta_cycles = 0     # heartbeats dispatched down each path
        self.full_cycles = 0
        self.delta_join_cycles = 0
        self.full_join_cycles = 0
        self.last_scan_path = ""  # paths of the last dispatch
        self.last_join_path = ""
        self.last_delta_overflow = 0   # defensive invariant (always 0)
        self.last_parts_rebuilt: Dict[str, bool] = {}
        self.last_collect_stats = {"admitted": 0, "dirty": 0,
                                   "scan_path": "", "join_path": "",
                                   "t_stage_s": 0.0, "t_dispatch_s": 0.0,
                                   "t_kernel_s": 0.0, "t_collect_s": 0.0,
                                   "backend_ops": {}}

    def _build_cycles(self) -> None:
        """Lower the plan and build its three cycle flavours, each through
        its own counting wrapper (``CycleResult.backend_ops``)."""
        plan, dev = self.plan, self.device
        self._lowered = lower_plan(plan, key_stats=self._key_stats)
        self.backend_ops: Dict[str, Dict[str, int]] = {
            "full": {}, "delta": {}, "delta_join": {}}
        cb = {f: counting_backend(self._backend, c)
              for f, c in self.backend_ops.items()}
        self._cycle = _clear_counts_at_entry(
            build_cycle(self._lowered, cb["full"], dev),
            self.backend_ops["full"])
        self._cycle_delta = _clear_counts_at_entry(
            build_delta_cycle(self._lowered, cb["delta"], device=dev),
            self.backend_ops["delta"])
        self._cycle_delta_join = _clear_counts_at_entry(
            build_delta_cycle(self._lowered, cb["delta_join"],
                              delta_joins=True, device=dev),
            self.backend_ops["delta_join"])
        # join stages with carried rid state (non-gather paths)
        self._carried_joins = tuple(j for j in self._lowered.joins
                                    if j.kind != "gather")
        # the admission layout the carries live under
        self._layout_token = (plan.qcap, plan.n_params_max,
                              tuple(sorted(plan.offsets.items())),
                              tuple(sorted(plan.caps.items())))

    # ------------------------------------------------------------------ API
    def submit(self, template: str, params: Dict[str, Any]) -> Ticket:
        """params: {pred_index: (lo, hi)} inclusive int ranges."""
        t = Ticket(next(self._ticket_ids), template, params, time.time())
        self._queues[template].append(t)
        return t

    def submit_update(self, table: str, kind: str, payload: Dict) -> None:
        """kind: insert | update | delete (payload per storage slots)."""
        self._update_queue.append((table, kind, payload))

    def pending(self) -> int:
        return (sum(len(q) for q in self._queues.values())
                + len(self._update_queue))

    # ------------------------------------------------------------ one beat
    def _admit_queries(self, buf: _StagingBuffers):
        """Drain the queues into the packed staging buffers."""
        admitted = {}
        params, active = buf.params, buf.active
        for name, tpl in self.plan.templates.items():
            cap = self.plan.caps[name]
            off = self.plan.offsets[name]
            take: List[Ticket] = []
            q = self._queues[name]
            while q and len(take) < cap:
                take.append(q.popleft())
            for slot, ticket in enumerate(take):
                g = off + slot
                active[g] = True
                for pi in range(len(tpl.preds)):
                    lo, hi = ticket.params[pi]
                    params[g, pi, 0] = lo
                    params[g, pi, 1] = hi
            admitted[name] = take
        return admitted

    def _admit_updates(self, buf: _StagingBuffers) -> Dict[str, int]:
        """Drain the update queue into the staging batches, FIFO per
        table and kind; returns each table's admitted touch count."""
        cat = self.plan.catalog
        s = self.update_slots
        fill = {t: {"ins": 0, "upd": 0, "del": 0} for t in cat.schemas}
        hold = collections.deque()
        while self._update_queue:
            table, kind, payload = self._update_queue.popleft()
            b, f = buf.updates[table], fill[table]
            if kind == "insert":
                if f["ins"] >= s.n_insert:
                    hold.append((table, kind, payload))
                    continue
                i = f["ins"]
                for c, v in payload.items():
                    b["ins_rows"][c][i] = int(v)
                b["ins_mask"][i] = True
                f["ins"] += 1
            elif kind == "update":
                if f["upd"] >= s.n_update:
                    hold.append((table, kind, payload))
                    continue
                i = f["upd"]
                schema = cat.schemas[table]
                b["upd_key"][i] = int(payload["key"])
                b["upd_col"][i] = schema.columns.index(payload["col"])
                b["upd_val"][i] = int(payload["val"])
                b["upd_mask"][i] = True
                f["upd"] += 1
            else:
                if f["del"] >= s.n_delete:
                    hold.append((table, kind, payload))
                    continue
                i = f["del"]
                b["del_key"][i] = int(payload["key"])
                b["del_mask"][i] = True
                f["del"] += 1
        self._update_queue = hold
        # an exact upper bound on the rows each batch can dirty
        return {t: f["ins"] + f["upd"] + f["del"] for t, f in fill.items()}

    # -------------------------------------------------- incremental scans
    def _diff_admission(self, buf: _StagingBuffers) -> np.ndarray:
        """Changed-slot vector vs the previously dispatched heartbeat: a
        slot changed iff its activation flipped, or it stayed active with
        different parameters."""
        changed = buf.changed
        np.not_equal(buf.active, self._prev_active, out=changed)
        both = buf.active & self._prev_active
        if both.any():
            diff = (buf.params != self._prev_params).any(axis=(1, 2))
            np.logical_or(changed, both & diff, out=changed)
        return changed

    def _delta_eligible(self, changed: np.ndarray,
                        touches: Dict[str, int]) -> bool:
        """True iff every predicated scan's changed slots fit inside its
        contiguous admission pane and every table's batch fits its dirty
        set (conservative, host-side)."""
        schemas = self.plan.catalog.schemas
        for table, n in touches.items():
            if n > schemas[table].dirty_cap:
                return False
        for st in self._lowered.scans:
            if not st.cols:
                continue
            sc = changed[st.wlo * 32:st.whi * 32] & st.covered
            words = np.flatnonzero(sc.reshape(-1, 32).any(axis=1))
            if words.size and words[-1] - words[0] + 1 > st.delta_words:
                return False
        return True

    def _join_delta_eligible(self, touches: Dict[str, int]) -> bool:
        """True iff the plan has carried join stages, a rid carry exists
        and NO carried stage's PK table was touched this heartbeat."""
        if not self._carried_joins or self._rid_carry is None:
            return False
        return all(touches[j.pk_table] == 0 for j in self._carried_joins)

    def dispatch(self) -> None:
        """Admit one heartbeat's work and enqueue the global plan.

        Returns without waiting for the device; a later collect() claims
        the results.  At full pipeline depth the oldest in-flight
        heartbeat is collected first (backpressure), so a staging buffer
        is only rewritten after the heartbeat that read it completed.
        """
        while len(self._inflight) >= self.pipeline_depth:
            for name, tickets in self._collect_oldest().items():
                self._spilled.setdefault(name, []).extend(tickets)
        t0 = time.perf_counter()
        buf = self._staging[self._staging_idx]
        self._staging_idx = (self._staging_idx + 1) % len(self._staging)
        buf.reset()
        admitted = self._admit_queries(buf)
        touches = self._admit_updates(buf)
        # path choice, made HOST-side so the delta cycle never contains
        # the full-table compare: eligible when the carried words exist
        # and every delta fits its fixed capacity, else a full rescan
        # (which reseeds the carry)
        changed = self._diff_admission(buf)
        use_delta = (self._carry is not None
                     and self._delta_eligible(changed, touches))
        use_delta_join = use_delta and self._join_delta_eligible(touches)
        staged = buf.stage()
        queries = {"params": staged["params"], "active": staged["active"]}
        updates = staged["updates"]
        t_staged = time.perf_counter()
        if use_delta:
            check_carry_layout(self._carry_token, self._layout_token)
            queries["changed"] = staged["changed"]
            if use_delta_join:
                self.state, self._carry, results = self._cycle_delta_join(
                    self.state, self._carry, self._rid_carry, queries,
                    updates)
            else:
                self.state, self._carry, results = self._cycle_delta(
                    self.state, self._carry, queries, updates)
            self.delta_cycles += 1
        else:
            self.state, self._carry, results = self._cycle(
                self.state, queries, updates)
            self.full_cycles += 1
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        t_launched = time.perf_counter()
        # both carry halves are (re)seeded by EVERY heartbeat
        self._rid_carry = results["_join_rids"]
        self._carry_token = self._layout_token
        self.last_scan_path = "delta" if use_delta else "full"
        if self._carried_joins:
            self.last_join_path = "delta" if use_delta_join else "full"
            if use_delta_join:
                self.delta_join_cycles += 1
            else:
                self.full_join_cycles += 1
        self._prev_params[...] = buf.params
        self._prev_active[...] = buf.active
        flavour = ("delta_join" if use_delta_join else "delta") \
            if use_delta else "full"
        self._inflight.append(_InFlight(
            admitted, results, done=done,
            n_admitted=sum(len(ts) for ts in admitted.values()),
            n_dirty=sum(touches.values()),
            scan_path=self.last_scan_path,
            join_path=self.last_join_path,
            t_stage_s=t_staged - t0,
            t_dispatch_s=t_launched - t_staged,
            backend_ops=dict(self.backend_ops[flavour])))

    def collect(self) -> Dict[str, List[Ticket]]:
        """Wait for the oldest in-flight heartbeat and route its results
        (plus any routing spilled by dispatch()-side backpressure, so
        every admitted ticket appears in exactly one collect())."""
        out, self._spilled = self._spilled, {}
        for name, tickets in self._collect_oldest().items():
            out.setdefault(name, []).extend(tickets)
        stats, self._spilled_stats = self._spilled_stats, []

        def one_path(paths):
            paths = {p for p in paths if p}
            return (paths.pop() if len(paths) == 1
                    else "mixed" if paths else "")

        ops: Dict[str, int] = {}
        for f in stats:
            for op, n in f.backend_ops.items():
                ops[op] = ops.get(op, 0) + n
        self.last_collect_stats = {
            "admitted": sum(f.n_admitted for f in stats),
            "dirty": sum(f.n_dirty for f in stats),
            "scan_path": one_path(f.scan_path for f in stats),
            "join_path": one_path(f.join_path for f in stats),
            "t_stage_s": sum(f.t_stage_s for f in stats),
            "t_dispatch_s": sum(f.t_dispatch_s for f in stats),
            "t_kernel_s": sum(f.t_kernel_s for f in stats),
            "t_collect_s": sum(f.t_collect_s for f in stats),
            "backend_ops": ops}
        return out

    def _collect_oldest(self) -> Dict[str, List[Ticket]]:
        if not self._inflight:
            return {}
        flight = self._inflight.popleft()
        self._spilled_stats.append(flight)
        results = flight.results
        t0 = time.perf_counter()
        if flight.done is not None:
            flight.done.synchronize()
        t_ready = time.perf_counter()
        self.last_overflow = int(results["_overflow"])
        self.last_delta_overflow = int(results.get("_delta_overflow", 0))
        self.last_parts_rebuilt = {
            t: bool(v) for t, v in results["_parts_rebuilt"].items()}
        now = time.time()
        out = {}
        for name, tickets in flight.admitted.items():
            res = {k: v.cpu().numpy() for k, v in results[name].items()}
            for slot, ticket in enumerate(tickets):
                ticket.result = {k: v[slot] for k, v in res.items()}
                ticket.done_time = now
            out[name] = tickets
            self.queries_done += len(tickets)
        flight.t_kernel_s = t_ready - t0
        flight.t_collect_s = time.perf_counter() - t_ready
        self.cycles_run += 1
        return out

    def run_cycle(self) -> Dict[str, List[Ticket]]:
        """One synchronous heartbeat: dispatch then drain all in-flight."""
        self.dispatch()
        out: Dict[str, List[Ticket]] = {}
        while self._inflight:
            for name, tickets in self.collect().items():
                out.setdefault(name, []).extend(tickets)
        return out

    def run_until_drained(self, max_cycles: int = 1000,
                          pipelined: bool = False) -> List[CycleResult]:
        """Cycle until the queues are empty; one ``CycleResult`` per
        collected heartbeat (``max_cycles`` bounds collects, and
        dispatches are capped by the same budget).  pipelined=True keeps
        up to ``pipeline_depth`` heartbeats in flight."""
        depth = self.pipeline_depth if pipelined else 1
        done: List[CycleResult] = []
        dispatched = 0
        t_prev = time.time()
        while len(done) < max_cycles and (self.pending() or self._inflight
                                          or self._spilled):
            while (self.pending() and dispatched < max_cycles
                   and len(self._inflight) < depth):
                self.dispatch()
                dispatched += 1
            if not self._inflight and not self._spilled:
                break       # budget exhausted with work still queued
            routed = self.collect()
            now = time.time()
            s = self.last_collect_stats
            done.append(CycleResult(tickets=routed, wall_s=now - t_prev,
                                    admitted=s["admitted"],
                                    dirty=s["dirty"],
                                    scan_path=s["scan_path"],
                                    join_path=s["join_path"],
                                    t_stage_s=s["t_stage_s"],
                                    t_dispatch_s=s["t_dispatch_s"],
                                    t_kernel_s=s["t_kernel_s"],
                                    t_collect_s=s["t_collect_s"],
                                    backend_ops=s["backend_ops"]))
            t_prev = now
        return done

    # --------------------------------------------------- host-side fetch
    def snapshot(self, table: str) -> Dict[str, np.ndarray]:
        """Host view of a table's columns/validity."""
        schema = self.plan.catalog.schemas[table]
        t = self.state[table]
        out = {c: t[c].cpu().numpy() for c in schema.columns}
        out["_valid"] = t["_valid"].cpu().numpy()
        out["_n"] = int(t["_n"])
        return out

    def materialize(self, table: str, row_ids: np.ndarray,
                    cols: Optional[List[str]] = None) -> Dict[str, np.ndarray]:
        """Fetch tuples by row id from the current snapshot (result
        delivery — the Output operator of Fig. 5)."""
        schema = self.plan.catalog.schemas[table]
        cols = cols or list(schema.columns)
        ids = np.asarray(row_ids)
        safe = np.clip(ids, 0, schema.capacity - 1)
        out = {c: np.where(ids >= 0, self.state[table][c].cpu().numpy()[safe],
                           0) for c in cols}
        out["_row"] = ids
        return out
