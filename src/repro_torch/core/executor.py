"""Heartbeat executor (paper §3.2, §4.2, Algorithm 1) — pipelined, on one
device.

While one batch of queries and updates executes, newly arriving work
queues; at each heartbeat the queues are drained (up to the per-template
slot capacity — excess stays queued, the paper's admission rule) and
pushed through ONE heartbeat of the global plan.

The heartbeat is split so host and device overlap:

  dispatch() — drain the queues into PREALLOCATED pinned staging buffers,
               copy them into the pipeline slot's fixed device buffers
               (two asynchronous copies), replay the slot's captured
               graph of the chosen cycle flavour and queue ONE copy of
               the slot's packed results to its pinned host mirror right
               behind it: a few copies and ONE graph launch on the
               current stream (``jit=True`` on a card; with
               ``jit=False``, and on the CPU, the same body runs
               eagerly, and the same copy follows it).  Nothing in it
               waits for the device.
  collect()  — wait for the oldest in-flight heartbeat's completion
               event (recorded behind its copy-out, so it never waits
               for a later beat) and route its results from host memory
               to the waiting tickets.

With double-buffered admission (pipeline depth 2) the queue draining and
parameter staging for heartbeat N+1 overlap device execution of N; a
staging buffer is reused only after the heartbeat that read it was
collected.

Scans AND joins are incremental: every heartbeat leaves a carry (scan
words + key partitions) and each join's rids in
``results["_join_rids"]``, which the executor threads forward as the rid
half of the carry.  The next dispatch runs a DELTA cycle when the carry
exists and the heartbeat's deltas fit their fixed capacities, and its
``delta_joins`` variant when additionally no carried join's PK table was
touched; every choice is made host-side from exact admission knowledge.

One body, static addresses (the reference donates its state and carries
to jit instead): every tensor that crosses a beat boundary lives in
buffers the engine owns, allocated once per plan generation outside
every graph pool.  State and scan carry are ONE copy rolled forward in
place — the body ends by copying each changed leaf into the engine's
tensor.  Each pipeline slot owns its staged admission and its results,
whose ``_join_rids`` are the slot's rid carry: slot S's graphs read slot
S-1's rids and write slot S's, so the rids a beat reads are never the
ones it writes, and a beat's results stay intact until it is collected.
There are ``max(2, pipeline_depth)`` slots.  A slot's results but its
rids are views into one flat device buffer (``_Mirror``) that each beat
of the slot copies, whole, to the slot's pinned host mirror.

Plan folding (core/folding.py): ``begin_fold`` builds (and on a card
captures) the cycles of an extended plan on a background thread while
the installed ones keep serving; the next dispatch() after the build
lands drains the in-flight beats, installs the new generation, migrates
the carries into its buffers and forces one full-rescan beat.

Under a row mesh (``mesh=``, core/sharding.py) the same lowered plan runs
sharded by spine-row range: state, carries, rids and the staged admission
hold one tree per shard, each beat runs the S shard bodies (and, in a
reseed, one all_gather per mirrored predicated stage) and then the
cross-shard merge, all in the one captured graph when every shard is on
one card; ``collect`` assembles the merged results and copies them out
(a mesh generation has no host mirror).

Tracing (``trace=True``): every beat's body marks its stage boundaries
(``graphs.mark``; the stage names are ``core/lowering.py``'s, between
``start`` and ``commit``), as event-record nodes of the captured graphs
on a card, and ``collect`` turns them into device seconds per stage
(``last_collect_stats["stage_s"]``).  While a torch profiler runs, the
host steps of ``dispatch`` and ``collect`` are also profiler ranges
(``repro.dispatch.admit`` / ``.stage`` / ``.launch`` / ``.backpressure``,
``repro.collect.wait`` / ``.copy_out`` / ``.route``).  With
``trace=False`` no graph holds an event and no record grows.  Every
host stamp (tickets, write acknowledgements, spans) is
``time.perf_counter()``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import os
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import kernels as _k
from repro_torch.analysis_static.ir_passes import run_construction_passes
from repro_torch.analysis_static.registry import FOLD_IN_FLIGHT
from repro_torch.core import folding
from repro_torch.core import graphs as cg
from repro_torch.core import sharding
from repro_torch.core.backends import counting_backend, resolve_backend
from repro_torch.core.device import resolve_device
from repro_torch.core.lowering import (PARTITIONED_MIN_CAPACITY, build_cycle,
                                       build_delta_cycle, lower_plan)
from repro_torch.core.plan import CompiledPlan, QueryTemplate
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
    """A query's ticket.  ``beat`` is the sequence number of the dispatch
    that admitted it, ``admit_time`` that admission's stamp and
    ``done_time`` the collect() that routed its result (all
    ``perf_counter``)."""
    id: int
    template: str
    params: Any
    submit_time: float
    done_time: Optional[float] = None
    result: Any = None
    beat: Optional[int] = None
    admit_time: Optional[float] = None


@dataclasses.dataclass
class WriteTicket:
    """A write's acknowledgement, returned by ``submit_update``: ``beat``
    and ``admit_time`` as for a ``Ticket``; ``done_time`` is set by the
    collect() that completes its beat, which acknowledges the write."""
    id: int
    table: str
    kind: str
    submit_time: float
    beat: Optional[int] = None
    admit_time: Optional[float] = None
    done_time: Optional[float] = None


class _StagingBuffers:
    """Preallocated admission buffers for ONE pipeline slot.

    Every field of a heartbeat's admission — the packed [qcap, P_max, 2]
    parameters, the active and changed slot vectors, and every table's
    update batch (storage.empty_update_batch's layout) — is a numpy view
    into one of TWO flat host buffers, int32 and uint8 (the bools), held
    in pinned memory when the device is CUDA.  Staging a heartbeat is
    then two asynchronous copies into the slot's two fixed device
    buffers, whatever the template and table counts; ``staged`` is the
    device tree, views into those two buffers, the same every beat.

    ``copies`` (a row mesh's shard devices) gives every shard device
    buffers of its own, filled by the same two copies each: ``staged`` is
    then a tuple of one tree per shard.
    """

    def __init__(self, plan: CompiledPlan, slots: UpdateSlots,
                 device: torch.device, copies=None):
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
        devices = (device,) if copies is None else tuple(copies)
        self._dev = [(torch.empty_like(self._i32, device=d),
                      torch.empty_like(self._u8, device=d)) for d in devices]
        i32, u8 = self._i32.numpy(), self._u8.numpy().view(np.bool_)
        views, staged = {}, [{} for _ in devices]
        for path, b, off, n, shape in self._fields:
            src = layout
            for k in path:
                src = src[k]
            view = (u8 if b else i32)[off:off + n].reshape(shape)
            view[...] = src
            self._put(views, path, view)
            for tree, (d_i32, d_u8) in zip(staged, self._dev):
                leaf = d_u8[off:off + n].view(torch.bool) if b \
                    else d_i32[off:off + n]
                self._put(tree, path, leaf.view(shape))
        self.staged = staged[0] if copies is None else tuple(staged)
        self.params = views["params"]
        self.active = views["active"]
        self.changed = views["changed"]
        self.updates = views["updates"]
        self.stage()             # an empty admission until the first beat

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

    def stage(self) -> None:
        """Enqueue the admission's two copies into ``staged`` (into every
        shard's)."""
        for d_i32, d_u8 in self._dev:
            cuda = d_i32.device.type == "cuda"
            d_i32.copy_(self._i32, non_blocking=cuda)
            d_u8.copy_(self._u8, non_blocking=cuda)


@dataclasses.dataclass
class CycleResult:
    """One collected heartbeat: its routed tickets and accounting.

    ``admitted`` / ``dirty`` count the queries and update-touched rows
    the heartbeat carried; ``scan_path`` / ``join_path`` name the
    flavours it ran ("delta", "full", "mixed" when backpressure folded
    several heartbeats into one collect, "" for no carried joins).  The
    ``t_*_s`` fields are the host-time breakdown — staging (queue drain
    + buffer fill + copies enqueued), dispatch (the graph launched and
    the results' copy-out queued), wait (the collect-side wait for the
    beat's completion event), copy (the results copied out of the pinned
    host mirror into memory of their own; under a mesh, from the
    device) and route (results assembled and
    tickets routed); ``t_collect_s`` is copy + route.  ``stage_s`` is
    the device seconds of each stage of the beat's body (``{}`` unless
    the engine traces) and ``backend_ops`` the beat's backend
    launches."""
    tickets: Dict[str, List[Ticket]]
    admitted: int = 0
    dirty: int = 0
    scan_path: str = ""
    join_path: str = ""
    t_stage_s: float = 0.0
    t_dispatch_s: float = 0.0
    t_wait_s: float = 0.0
    t_copy_s: float = 0.0
    t_route_s: float = 0.0
    t_collect_s: float = 0.0
    stage_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    backend_ops: Dict[str, int] = dataclasses.field(default_factory=dict)


FLAVOURS = ("full", "delta", "delta_join")

#: The shipped donation contract, the reference's (``repro.core.executor.
#: DONATION_SPEC``): cycle flavour -> the arguments a beat's body writes in
#: place.  The cycles' arguments are (state, queries, updates) for
#: "full", (state, carry, queries, updates) for "delta" and (state,
#: carry, rid carry, queries, updates) for "delta_join".  The state (arg
#: 0) rolls forward in place; the delta flavours also roll the scan words
#: + key partitions (arg 1) forward.  The rid carry (arg 2 of the
#: delta-join flavour) is never written: it is the previous slot's
#: in-flight ``results["_join_rids"]``.  planlint's ``jaxpr-donated-alias``
#: pass (``analysis_static.trace_passes``) records a beat's in-place
#: writes and holds them to this spec.
DONATION_SPEC: Dict[str, tuple] = {
    "full": (0,), "delta": (0, 1), "delta_join": (0, 1)}


@dataclasses.dataclass
class _BeatBuffers:
    """What a beat's body reads and writes: the state, the scan carry and
    each pipeline slot's results (whose ``_join_rids`` are the slot's rid
    carry); the staged admission is the generation's."""
    state: Dict
    carry: Dict
    results: List[Dict]


@dataclasses.dataclass
class _Mirror:
    """One pipeline slot's results but its rid carry, packed: each leaf a
    view into ``packed``, one flat device buffer, which ``_run_beat``
    copies to the pinned ``host`` buffer in stream order right behind
    each beat of the slot."""
    packed: torch.Tensor        # uint8, on the device
    host: torch.Tensor          # uint8, pinned on a card
    layout: Any                 # the results tree of ``graphs.Span``s

    def read(self) -> Dict:
        """The results as numpy arrays in host memory of their own (the
        slot's next beat rewrites ``host``): numpy views of one copy,
        on an H100 host about a fifth of the time of torch views."""
        return cg.unpack(self.host.numpy().copy(), self.layout)


@dataclasses.dataclass
class _CompiledHandle:
    """One plan generation: its built cycles and the buffers and graphs
    its beats run on, swapped in one piece.

    A fold keeps serving from the installed handle while a background
    thread builds the next one for the extended plan; everything that
    depends on the admission layout lives here, so installing a handle
    IS the layout swap."""
    plan: CompiledPlan
    lowered: Any
    backend_ops: Dict[str, Dict[str, int]]
    cycles: Dict[str, Any]       # flavour -> cycle function
    carried_joins: tuple
    layout_token: tuple
    staging: List[_StagingBuffers] = dataclasses.field(default_factory=list)
    carry: Any = None            # the scan carry, rolled forward in place
    results: List[Dict] = dataclasses.field(default_factory=list)
    # each slot's packed results and host mirror; empty under a mesh
    mirrors: List[_Mirror] = dataclasses.field(default_factory=list)
    # (flavour, slot) -> captured graph; empty when the beats run eagerly
    graphs: Dict[tuple, cg.Graph] = dataclasses.field(default_factory=dict)
    capture_stats: Dict[str, Any] = dataclasses.field(default_factory=dict)
    ready: Any = None            # CUDA event behind the build's work on
    #                              its side stream (None on the CPU)
    gate_s: float = 0.0          # the construction gate's host seconds
    # under a row mesh: the layout, the device merge enqueued behind each
    # beat and the host epilogue of collect (core/sharding.build_merge)
    spec: Optional[sharding.ShardSpec] = None
    merge: Any = None
    assemble: Any = None


@dataclasses.dataclass
class _PendingFold:
    """A fold in flight: the extended plan and its background build."""
    plan: CompiledPlan
    t_begin: float = 0.0       # perf_counter at begin_fold
    t_built: float = 0.0       # ... when the build finished
    handle: Optional[_CompiledHandle] = None
    error: Optional[BaseException] = None
    thread: Optional[threading.Thread] = None
    built: threading.Event = dataclasses.field(
        default_factory=threading.Event)

    def ready(self) -> bool:
        return self.built.is_set()


@dataclasses.dataclass
class _InFlight:
    """One dispatched-but-not-collected heartbeat."""
    admitted: Dict[str, List[Ticket]]
    results: Any
    beat: int = 0               # the dispatch's sequence number
    slot: int = 0               # the pipeline slot it ran on
    writes: List[WriteTicket] = dataclasses.field(default_factory=list)
    writes_held: int = 0        # writes left queued behind the slots
    # the body's stage marks (a graph's events are recorded again by its
    # next replay, which waits until this flight is collected)
    marks: list = dataclasses.field(default_factory=list)
    done: Any = None            # CUDA event recorded behind the copy-out
    mirror: Optional[_Mirror] = None   # the slot's, of the beat's generation
    assemble: Any = None        # a mesh generation's collect epilogue
    n_admitted: int = 0
    n_dirty: int = 0
    scan_path: str = "full"
    join_path: str = ""
    t_stage_s: float = 0.0
    t_dispatch_s: float = 0.0
    t_wait_s: float = 0.0
    t_copy_s: float = 0.0
    t_route_s: float = 0.0
    d2h_copies: int = 0
    copies_at_dispatch: int = 0
    stage_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    backend_ops: Dict[str, int] = dataclasses.field(default_factory=dict)


class SharedDBEngine:
    """The always-on global plan + admission queues, on one device or
    sharded over a row mesh."""

    def __init__(self, plan: CompiledPlan, update_slots: UpdateSlots,
                 initial_data: Dict[str, Dict[str, np.ndarray]],
                 kernels: str = "auto", device=None,
                 pipeline_depth: int = 2, delta_scans: bool = True,
                 delta_joins: bool = True, jit: bool = True, mesh=None,
                 trace: bool = False):
        """``device=None`` runs on the CUDA card and raises when there is
        none; ``device="cpu"`` runs the plain PyTorch path.  ``kernels``:
        "auto" (``hopper`` on a card of capability 9.0+, ``torch`` on the
        CPU), "torch", "hopper" or another registered backend name.
        ``delta_scans=False`` / ``delta_joins=False`` keep every beat on
        the full rescan / the full join probe.  ``jit=True`` (the
        reference's name and default) captures each cycle flavour of
        every pipeline slot as a CUDA graph, once per plan generation,
        and every beat replays one; a capture that fails raises.
        ``jit=False``, and any engine on the CPU, runs the same body
        eagerly.  ``graphed`` says which mode is in force.

        ``mesh``: an optional ``sharding.RowMesh`` (``make_row_mesh``) —
        the always-on plan then runs SHARDED by spine-row range
        (core/sharding.py): row-sharded spine tables and carries, mirrored
        join probe sides, shard-local delta beats, all-shard reseed beats
        and a device merge of the per-shard results enqueued behind each
        beat (collect assembles).  The engine's ``device`` is then the
        mesh's first (``device`` must be None or that one).  ``mesh=None``
        is the single-device path, untouched; a 1-shard mesh is
        bit-identical to it.  With ``jit=True`` a mesh whose shards all
        sit on one card captures each whole sharded beat (the shard
        bodies, the all_gather and the merge) as one graph; on distinct
        CUDA devices it raises (graphs across devices are unverified).
        A mesh the engine cannot run raises; nothing falls back to one
        shard.

        ``trace=True`` times every beat's stages on the device (graphed:
        timing events captured in each graph) and, while a torch profiler
        runs, marks ``dispatch`` / ``collect``'s host steps as profiler
        ranges (module docstring).  A mesh engine does not trace: its
        shard bodies would repeat the marks, so ``trace=True`` with a
        mesh raises."""
        if mesh is not None and trace:
            raise NotImplementedError(
                "trace=True on a mesh: the shard bodies would repeat the "
                "stage marks")
        self.trace = bool(trace)
        self._mesh = mesh
        if mesh is not None:
            mesh_dev = mesh.devices[0]
            if device is not None and \
                    sharding._mesh_device(device) != mesh_dev:
                raise ValueError(f"device {device} is not the mesh's first "
                                 f"device {mesh_dev}")
            device = mesh_dev
            if jit and mesh_dev.type == "cuda" and not mesh.one_device:
                raise NotImplementedError(
                    "jit=True on a mesh of distinct CUDA devices: graphs "
                    "across devices are unverified; pass jit=False")
            kinds = {d.type for d in mesh.devices}
            if len(kinds) != 1:
                raise ValueError(f"a mesh mixes device types {kinds}")
        self.device = resolve_device(device)
        self.graphed = bool(jit) and self.device.type == "cuda"
        self.plan = plan
        self.update_slots = update_slots
        self._queues: Dict[str, collections.deque] = {
            name: collections.deque() for name in plan.templates}
        # (WriteTicket, payload) in arrival order
        self._update_queue: collections.deque = collections.deque()
        self._ticket_ids = itertools.count()
        self._write_ids = itertools.count()
        self._beat_seq = 0           # the next dispatch's sequence number
        self._admitted_writes: List[WriteTicket] = []   # the last admission's
        self._backend = resolve_backend(kernels, self.device)
        # measured once from the initial snapshot and reused by every
        # re-lower (folds): the partition geometry must stay identical
        # across generations for the carried key partitions to remap
        self._key_stats = _measure_key_stats(plan, initial_data)
        self.delta_scans = delta_scans
        self.delta_joins = delta_joins
        self.pipeline_depth = max(1, pipeline_depth)
        if mesh is not None:
            self.state = sharding.init_sharded_state(
                sharding.build_shard_spec(plan, mesh), initial_data)
        else:
            self.state = plan.catalog.init_state(initial_data, self.device)
        # capture seconds, graph count and pool bytes of each generation
        self.capture_stats: List[Dict[str, Any]] = []
        # host seconds of the planlint construction gate, per generation
        self.gate_s: List[float] = []
        self._install_handle(self._build_compiled(plan))
        self._fold: Optional[_PendingFold] = None
        self.folds_done = 0
        self.last_fold_build_s = None   # begin_fold -> build done, seconds
        # set by a fold commit: the first post-fold heartbeat is a FORCED
        # full-rescan reseed under the new layout
        self._force_full = False
        self._carry = None           # the scan words + key partitions
        #                              (the generation's), once seeded
        self._rid_carry = None       # previous heartbeat's join rids
        self._carry_token = None
        # (active, params) of the last DISPATCHED heartbeat: the delta
        # path diffs against these to find changed admission slots
        self._prev_params = np.zeros((plan.qcap, plan.n_params_max, 2),
                                     np.int32)
        self._prev_active = np.zeros((plan.qcap,), bool)
        self._staging_idx = 0
        self._inflight: collections.deque[_InFlight] = collections.deque()
        # routing from backpressure collects inside dispatch(), surfaced
        # by the next public collect()
        self._spilled: Dict[str, List[Ticket]] = {}
        self._spilled_stats: List[_InFlight] = []
        self.cycles_run = 0
        self.last_overflow = 0    # union-cap overflow of the last collect
        self.delta_cycles = 0     # heartbeats dispatched down each path
        self.full_cycles = 0
        self.delta_join_cycles = 0
        self.last_scan_path = ""  # paths of the last dispatch
        self.last_join_path = ""
        self.last_delta_overflow = 0   # defensive invariant (always 0)
        self.last_parts_rebuilt: Dict[str, bool] = {}
        self.last_collect_stats = self._collect_stats([])

    # --------------------------------------------- compiled-cycle handle
    def _build_compiled(self, plan: CompiledPlan) -> _CompiledHandle:
        """Lower one plan generation, build its three cycle flavours
        (each through its own counting wrapper, ``CycleResult.
        backend_ops``), allocate the buffers its beats run on and, when
        ``graphed``, capture every (flavour, slot) graph.

        Pure with respect to the engine's serving state, so a background
        fold thread can run it while the installed generation keeps
        beating: on a card everything runs on a side stream of its own,
        its constants go up through pinned memory without a wait, the
        warm-ups run on throwaway state, carries and results, and the
        build returns once its work has run on the card (an event
        polled, never a synchronising call).  While it captures, no other
        thread may synchronise the whole device (``torch.cuda.
        synchronize()``; CUDA refuses it during a capture): the engine's
        own waits are on events and on the serving stream.

        Always-on planlint: the IR passes gate EVERY generation (cold
        start and every fold build) right after lowering, before any
        buffer is allocated or any graph captured, and raise
        ``PlanLintError`` naming the rule.  The gate reads the host IR
        only and never waits for the device.

        Under a mesh the flavours are the sharded ones
        (``sharding.build_sharded_cycle`` / ``build_sharded_delta_cycle``)
        with the generation's device merge and collect epilogue
        (``sharding.build_merge``), built after the gate."""
        dev = self.device
        lowered = lower_plan(plan, key_stats=self._key_stats)
        t_gate = time.perf_counter()
        run_construction_passes(lowered, key_stats=self._key_stats)
        gate_s = time.perf_counter() - t_gate
        backend_ops: Dict[str, Dict[str, int]] = {f: {} for f in FLAVOURS}
        cb = {f: counting_backend(self._backend, c)
              for f, c in backend_ops.items()}
        spec = None if self._mesh is None else \
            sharding.build_shard_spec(plan, self._mesh)
        h = _CompiledHandle(
            plan=plan, lowered=lowered, backend_ops=backend_ops,
            cycles={},
            # join stages with carried rid state (non-gather paths)
            carried_joins=tuple(j for j in lowered.joins
                                if j.kind != "gather"),
            # the admission layout this generation's carries live under
            layout_token=(plan.qcap, plan.n_params_max,
                          tuple(sorted(plan.offsets.items())),
                          tuple(sorted(plan.caps.items())),
                          spec.n_shards if spec else 0),
            gate_s=gate_s, spec=spec)
        cuda = dev.type == "cuda"
        with (torch.cuda.stream(torch.cuda.Stream(dev)) if cuda
              else contextlib.nullcontext()):
            if spec is None:
                cycles = (
                    ("full", build_cycle(lowered, cb["full"], dev)),
                    ("delta", build_delta_cycle(lowered, cb["delta"],
                                                device=dev)),
                    ("delta_join", build_delta_cycle(
                        lowered, cb["delta_join"], delta_joins=True,
                        device=dev)))
            else:
                cycles = (
                    ("full", sharding.build_sharded_cycle(
                        lowered, cb["full"], spec)),
                    ("delta", sharding.build_sharded_delta_cycle(
                        lowered, cb["delta"], spec)),
                    ("delta_join", sharding.build_sharded_delta_cycle(
                        lowered, cb["delta_join"], spec, delta_joins=True)))
                h.merge, h.assemble = sharding.build_merge(lowered, spec)
            h.cycles = {f: _clear_counts_at_entry(c, backend_ops[f])
                        for f, c in cycles}
            n_slots = max(2, self.pipeline_depth)
            h.staging = [_StagingBuffers(
                plan, self.update_slots, dev,
                copies=None if spec is None else spec.devices)
                for _ in range(n_slots)]
            # one throwaway full beat on an empty state: the shapes of the
            # carry and of a slot's results
            with _k.recording():
                scratch = plan.catalog.init_state({}, dev) if spec is None \
                    else sharding.init_sharded_state(spec, {})
                _, carry, results = self._cycle_out(
                    h, "full", scratch, None, None, h.staging[0].staged)
            if spec is None:
                results["_delta_overflow"] = torch.zeros(
                    (), dtype=torch.int32, device=dev)
            h.carry = cg.empty_like_tree(carry)
            if spec is None:
                # a slot's results but its rid carry are views into one
                # flat buffer, copied out in one piece behind each beat
                layout, nbytes = cg.pack_layout(
                    {k: v for k, v in results.items() if k != "_join_rids"})
                for _ in range(n_slots):
                    m = _Mirror(
                        torch.empty(nbytes, dtype=torch.uint8, device=dev),
                        torch.empty(nbytes, dtype=torch.uint8,
                                    pin_memory=cuda), layout)
                    views = cg.unpack(m.packed, layout)
                    h.mirrors.append(m)
                    h.results.append(
                        {k: cg.empty_like_tree(v) if k == "_join_rids"
                         else views[k] for k, v in results.items()})
            else:
                h.results = [cg.empty_like_tree(results)
                             for _ in range(n_slots)]
            if self.graphed:
                self._capture(h, _BeatBuffers(
                    scratch, carry,
                    [results] + [cg.clone_tree(results)
                                 for _ in range(n_slots - 1)]))
            if cuda:
                h.ready = torch.cuda.Event()
                h.ready.record()
                while not h.ready.query():
                    time.sleep(0.0005)
        return h

    def _capture(self, h: _CompiledHandle, scratch: _BeatBuffers) -> None:
        """Warm each flavour up on ``scratch`` (throwaway state, carry and
        results: it fills the kernels' geometry caches before a capture
        bakes their addresses in; its launches serve no beat, so they
        count in a throwaway record), then capture every (flavour, slot)
        body on the live buffers into one graph pool; the graphs replay
        one at a time on one stream, and nothing that outlives a replay
        lives in the pool, so they share it."""
        t0 = time.perf_counter()
        with _k.recording():
            for f in FLAVOURS:
                self._body(h, scratch, f, 1)
        t1 = time.perf_counter()
        live = _BeatBuffers(self.state, h.carry, h.results)
        pool = torch.cuda.graph_pool_handle()
        for f in FLAVOURS:
            for slot in range(len(h.staging)):
                h.graphs[f, slot] = cg.capture(
                    lambda f=f, slot=slot: self._body(h, live, f, slot),
                    pool, marks=self.trace)
        h.capture_stats = {"warmup_s": t1 - t0,
                           "capture_s": time.perf_counter() - t1,
                           "graphs": len(h.graphs),
                           "pool_bytes": cg.pool_bytes(pool)}

    def _install_handle(self, h: _CompiledHandle) -> None:
        """Swap the serving generation (at a beat boundary)."""
        if h.ready is not None:
            # the beats that follow wait, on the card, for the build's
            # side stream, and the allocator holds the generation's
            # buffers for the serving stream's work when they are freed
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(h.ready)
            for t in cg.leaves((h.carry, tuple(h.results),
                                tuple(b.staged for b in h.staging))):
                t.record_stream(stream)
        self._gen = h
        self.plan = h.plan
        self._lowered = h.lowered
        self.backend_ops = h.backend_ops
        self._carried_joins = h.carried_joins
        self._layout_token = h.layout_token
        self.capture_stats.append(dict(h.capture_stats,
                                       generation=len(self.capture_stats)))
        self.gate_s.append(h.gate_s)

    # -------------------------------------------------------- the beat body
    @staticmethod
    def _cycle_out(h: _CompiledHandle, flavour: str, state, carry, rids,
                   staged):
        """One cycle of ``flavour`` on the given tensors: (state', carry',
        results), out of place except fused_delta's in-place carry."""
        keys = ("params", "active") if flavour == "full" \
            else ("params", "active", "changed")
        if h.spec is None:
            queries = {k: staged[k] for k in keys}
            updates = staged["updates"]
        else:
            queries = tuple({k: s[k] for k in keys} for s in staged)
            updates = tuple(s["updates"] for s in staged)
        if flavour == "full":
            out = h.cycles["full"](state, queries, updates)
        elif flavour == "delta_join":
            out = h.cycles["delta_join"](state, carry, rids, queries,
                                         updates)
        else:
            out = h.cycles["delta"](state, carry, queries, updates)
        if h.spec is not None:
            # the cross-shard merge, enqueued behind the shard bodies
            out[2]["_merged"] = h.merge(out[2]["_shard"])
        return out

    def _body(self, h: _CompiledHandle, buf: _BeatBuffers, flavour: str,
              slot: int) -> None:
        """The beat's body, the one that is captured: slot ``slot``'s
        staged admission and slot ``slot - 1``'s rids in, slot ``slot``'s
        results, the scan carry and the state rolled forward in place."""
        cg.mark("start")
        out = buf.results[slot]
        state, carry, results = self._cycle_out(
            h, flavour, buf.state, buf.carry,
            buf.results[slot - 1]["_join_rids"], h.staging[slot].staged)
        if h.spec is None and "_delta_overflow" not in results:
            out["_delta_overflow"].zero_()
            results["_delta_overflow"] = out["_delta_overflow"]
        cg.copy_into(out, results)
        cg.copy_into(buf.carry, carry)
        cg.copy_into(buf.state, state)
        cg.mark("commit")

    def _run_beat(self, flavour: str, slot: int) -> list:
        """Run (replay or, eagerly, call) one beat's body, then queue the
        copy of the slot's packed results to its host mirror, right
        behind the body in stream order; returns the stage marks (empty
        unless tracing)."""
        h = self._gen
        if h.graphs:
            g = h.graphs[flavour, slot]
            g.replay()
            marks = g.marks
        else:
            sink = cg.MarkSink(self.device) if self.trace else None
            with cg.marking(sink):
                self._body(h, _BeatBuffers(self.state, h.carry, h.results),
                           flavour, slot)
            marks = sink.marks if sink is not None else []
        if h.mirrors:
            m = h.mirrors[slot]
            m.host.copy_(m.packed, non_blocking=True)
        return marks

    def _range(self, name: str):
        """A profiler range over a host step, only while tracing under a
        running profiler."""
        if self.trace and torch.autograd._profiler_enabled():
            return torch.autograd.profiler.record_function(name)
        return contextlib.nullcontext()

    # ------------------------------------------------------ plan folding
    def begin_fold(self, new_templates: List[QueryTemplate],
                   new_caps: Dict[str, int],
                   background: bool = True) -> dict:
        """Fold new templates into the running plan (core/folding.py).

        Validates the extension synchronously (a recompile of the plan
        graph, no lowering), opens admission queues for the new
        templates at once (their queries queue and are served after the
        fold commits), and builds the extended generation's cycles on a
        background thread while the current ones keep beating.  The
        swap happens at the next dispatch() after the build finishes:
        drain in-flight beats, install the new handle, migrate the
        carries, force one full-rescan beat.  Returns the ``background``
        variant of runtime/elastic.relower_recipe."""
        from repro_torch.runtime.elastic import relower_recipe
        if self._fold is not None:
            raise RuntimeError(
                f"[planlint:{FOLD_IN_FLIGHT}] a fold is already in flight "
                "— wait for it to commit before starting another "
                "(serving front ends batch registrations instead)")
        new_templates = list(new_templates)
        new_plan = folding.extend_plan(self.plan, new_templates,
                                       dict(new_caps))
        if self._mesh is not None:
            sharding.check_fold_mirrors(self.plan, new_plan)
        for t in new_templates:
            self._queues.setdefault(t.name, collections.deque())
        fold = _PendingFold(plan=new_plan, t_begin=time.perf_counter())
        self._fold = fold
        if background:
            fold.thread = threading.Thread(target=self._fold_build,
                                           args=(fold,),
                                           name="plan-fold", daemon=True)
            fold.thread.start()
        else:
            self._fold_build(fold)
        return relower_recipe(tuple(self.plan.templates),
                              tuple(new_plan.templates),
                              what="the extended always-on plan",
                              background=True)

    def fold_in_flight(self) -> bool:
        return self._fold is not None

    def fold_ready(self) -> bool:
        return self._fold is not None and self._fold.ready()

    def _fold_build(self, fold: _PendingFold) -> None:
        """Background half of a fold: lower, build, warm up and capture
        the new generation (``_build_compiled``), the port's counterpart
        of the reference's ``_fold_warmup``: ``dispatch()`` never
        captures, so every beat stays free of syncs.

        On the fold thread it denices itself first (the build is slack
        work: the old generation keeps serving and commits the swap
        whenever the build lands) and makes the engine's device current.
        Any failure is kept and raised at commit."""
        try:
            if fold.thread is not None:
                try:
                    os.setpriority(os.PRIO_PROCESS,
                                   threading.get_native_id(), 19)
                except (AttributeError, OSError):
                    pass    # non-Linux / restricted: build at normal prio
            with (torch.cuda.device(self.device)
                  if self.device.type == "cuda"
                  else contextlib.nullcontext()):
                fold.handle = self._build_compiled(fold.plan)
        except BaseException as e:  # noqa: BLE001 — surfaced at commit
            fold.error = e
        finally:
            fold.t_built = time.perf_counter()
            fold.built.set()

    def _commit_fold(self) -> None:
        """The migration beat boundary: swap generations.

        Runs at dispatch() once the background build is ready.  In-flight
        beats drain first (their results are positional in the OLD
        layout; this waits for the card by design), the new generation
        installs with its staging buffers, the admission-diff state
        prefix-copies into the wider layout, and the carries migrate
        into the new generation's buffers (the rids into those slot 0
        reads) — through the same carry/layout check as the delta
        dispatch path — before one forced full-rescan beat reseeds
        everything under the new layout.  The old generation's graphs
        and their pool go."""
        fold, self._fold = self._fold, None
        if fold.thread is not None:
            fold.thread.join()
        if fold.error is not None:
            new = sorted(set(fold.plan.templates) - set(self.plan.templates))
            raise RuntimeError(f"background fold of {new} failed to "
                               "build") from fold.error
        self.last_fold_build_s = fold.t_built - fold.t_begin
        while self._inflight:
            for name, tickets in self._collect_oldest().items():
                self._spilled.setdefault(name, []).extend(tickets)
        old, old_plan, old_lowered = self._gen, self.plan, self._lowered
        self._install_handle(fold.handle)
        plan = self.plan
        # admission-diff state: the old slot ranges are a prefix of the
        # new layout, appended slots have never been admitted
        prev_p = np.zeros((plan.qcap, plan.n_params_max, 2), np.int32)
        prev_p[:old_plan.qcap, :old_lowered.n_params_max] = \
            self._prev_params
        prev_a = np.zeros((plan.qcap,), bool)
        prev_a[:old_plan.qcap] = self._prev_active
        self._prev_params, self._prev_active = prev_p, prev_a
        self._staging_idx = 0
        h = self._gen
        migrate = folding.migrate_carry if h.spec is None \
            else sharding.migrate_carry
        carry, rids = migrate(old_lowered, self._lowered, self._carry,
                              self._rid_carry)
        self._carry = self._rid_carry = None
        if carry is not None:
            cg.copy_into(h.carry, carry)
            self._carry = h.carry
        if rids is not None:
            last = h.results[-1]["_join_rids"]
            self._rid_carry = ({k: last[k] for k in rids} if h.spec is None
                               else tuple({k: lr[k] for k in r}
                                          for lr, r in zip(last, rids)))
            cg.copy_into(self._rid_carry, rids)
        for g in old.graphs.values():
            g.reset()
        if carry is not None:
            # version the swap: the migrated carry now lives under the
            # NEW layout token, proven through the always-on guard
            self._carry_token = self._layout_token
            check_carry_layout(self._carry_token, self._layout_token)
        else:
            self._carry_token = None
        self._force_full = True
        self.folds_done += 1

    # ------------------------------------------------------------------ API
    def submit(self, template: str, params: Dict[str, Any]) -> Ticket:
        """params: {pred_index: (lo, hi)} inclusive int ranges."""
        t = self.make_ticket(template, params)
        self.submit_ticket(t)
        return t

    def make_ticket(self, template: str, params: Dict[str, Any]) -> Ticket:
        """Mint a ticket WITHOUT enqueueing it (serving front ends hold
        tickets for templates still waiting on a fold batch)."""
        return Ticket(next(self._ticket_ids), template, params,
                      time.perf_counter())

    def accepts(self, template: str) -> bool:
        """True iff the engine has an admission queue for the template
        (compiled in, or in an in-flight fold)."""
        return template in self._queues

    def submit_ticket(self, ticket: Ticket) -> None:
        self._queues[ticket.template].append(ticket)

    def submit_update(self, table: str, kind: str,
                      payload: Dict) -> WriteTicket:
        """kind: insert | update | delete (payload per storage slots).
        Writes are admitted FIFO per table and kind, up to the update
        slots of a beat; the returned ticket is acknowledged (its
        ``done_time`` set) by the collect() of the beat that carried it."""
        w = WriteTicket(next(self._write_ids), table, kind,
                        time.perf_counter())
        self._update_queue.append((w, payload))
        return w

    def pending(self) -> int:
        return (sum(len(q) for q in self._queues.values())
                + len(self._update_queue))

    def in_flight(self) -> int:
        return len(self._inflight)

    # ------------------------------------------------------------ one beat
    def _admit_queries(self, buf: _StagingBuffers, beat: int, now: float):
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
                ticket.beat, ticket.admit_time = beat, now
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
        table and kind; returns each table's admitted touch count (the
        admitted writes go to ``_admitted_writes``)."""
        cat = self.plan.catalog
        s = self.update_slots
        fill = {t: {"ins": 0, "upd": 0, "del": 0} for t in cat.schemas}
        hold = collections.deque()
        writes = self._admitted_writes = []
        while self._update_queue:
            w, payload = item = self._update_queue.popleft()
            table, kind = w.table, w.kind
            b, f = buf.updates[table], fill[table]
            if kind == "insert":
                if f["ins"] >= s.n_insert:
                    hold.append(item)
                    continue
                i = f["ins"]
                for c, v in payload.items():
                    b["ins_rows"][c][i] = int(v)
                b["ins_mask"][i] = True
                f["ins"] += 1
            elif kind == "update":
                if f["upd"] >= s.n_update:
                    hold.append(item)
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
                    hold.append(item)
                    continue
                i = f["del"]
                b["del_key"][i] = int(payload["key"])
                b["del_mask"][i] = True
                f["del"] += 1
            writes.append(w)
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
        the results.  The beat's results are copied to the slot's pinned
        host mirror in stream order right behind its body, ahead of any
        later beat, and the completion event is recorded behind that
        copy (a mesh generation copies at collect instead).  At full
        pipeline depth the oldest in-flight
        heartbeat is collected first (backpressure), so a staging buffer
        is only rewritten after the heartbeat that read it completed.
        When a fold's build has landed, this beat first commits it
        (``_commit_fold``) and runs as the forced full rescan.
        """
        if self._fold is not None and self._fold.ready():
            # migration beat boundary: swap generations before admitting
            # this heartbeat's work
            self._commit_fold()
        with self._range("repro.dispatch.backpressure"):
            while len(self._inflight) >= self.pipeline_depth:
                for name, tickets in self._collect_oldest().items():
                    self._spilled.setdefault(name, []).extend(tickets)
        t0 = time.perf_counter()
        beat, self._beat_seq = self._beat_seq, self._beat_seq + 1
        h, slot = self._gen, self._staging_idx
        buf = h.staging[slot]
        self._staging_idx = (slot + 1) % len(h.staging)
        with self._range("repro.dispatch.admit"):
            buf.reset()
            admitted = self._admit_queries(buf, beat, t0)
            touches = self._admit_updates(buf)
            writes = self._admitted_writes
            for w in writes:
                w.beat, w.admit_time = beat, t0
            # path choice, made HOST-side so the delta cycle never
            # contains the full-table compare: eligible when the carried
            # words exist and every delta fits its fixed capacity, else a
            # full rescan (which reseeds the carry)
            changed = self._diff_admission(buf)
            force_full, self._force_full = self._force_full, False
            use_delta = (not force_full and self.delta_scans
                         and self._carry is not None
                         and self._delta_eligible(changed, touches))
            use_delta_join = (use_delta and self.delta_joins
                              and self._join_delta_eligible(touches))
        with self._range("repro.dispatch.stage"):
            buf.stage()
        t_staged = time.perf_counter()
        flavour = ("delta_join" if use_delta_join else "delta") \
            if use_delta else "full"
        if use_delta:
            check_carry_layout(self._carry_token, self._layout_token)
            self.delta_cycles += 1
        else:
            self.full_cycles += 1
        with self._range("repro.dispatch.launch"):
            marks = self._run_beat(flavour, slot)
            done = None
            if self.device.type == "cuda":
                done = torch.cuda.Event()
                done.record()
        results = h.results[slot]
        t_launched = time.perf_counter()
        # both carry halves are (re)seeded by EVERY heartbeat
        self._carry = h.carry
        self._rid_carry = results["_join_rids"]
        self._carry_token = self._layout_token
        self.last_scan_path = "delta" if use_delta else "full"
        if self._carried_joins:
            self.last_join_path = "delta" if use_delta_join else "full"
            if use_delta_join:
                self.delta_join_cycles += 1
        self._prev_params[...] = buf.params
        self._prev_active[...] = buf.active
        self._inflight.append(_InFlight(
            admitted, results, beat=beat, slot=slot, writes=writes,
            writes_held=len(self._update_queue), marks=marks, done=done,
            mirror=h.mirrors[slot] if h.mirrors else None,
            assemble=h.assemble, d2h_copies=1 if h.mirrors else 0,
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
        every admitted ticket appears in exactly one collect()).  On one
        device it waits for that beat's completion event alone and reads
        the results from host memory that the beat's own copy filled; a
        mesh generation assembles its shards' results and copies them
        from the device here."""
        out, self._spilled = self._spilled, {}
        for name, tickets in self._collect_oldest().items():
            out.setdefault(name, []).extend(tickets)
        stats, self._spilled_stats = self._spilled_stats, []
        self.last_collect_stats = self._collect_stats(stats)
        return out

    @staticmethod
    def _collect_stats(stats: List[_InFlight]) -> Dict[str, Any]:
        """``last_collect_stats`` over the flights one collect() took:
        the beats' ids, counts, paths, host spans (``t_copy_s`` is the
        host copy out of the pinned mirror, or under a mesh the copies
        from the device; ``t_collect_s`` is copy + route; ``t_kernel_s``
        is ``t_wait_s`` under its old name, which ``bench/harness.py``
        reads), device-to-host copies issued (``d2h_copies``: one a
        beat, queued at dispatch; under a mesh one a flag and result
        tensor, at collect), the beats whose results came from the
        mirror (``copies_at_dispatch``: on one device every beat, since
        the branch that reads the mirror counts it), writes held behind
        the update slots and device seconds per stage."""

        def one_path(paths):
            paths = {p for p in paths if p}
            return (paths.pop() if len(paths) == 1
                    else "mixed" if paths else "")

        ops: Dict[str, int] = {}
        stage_s: Dict[str, float] = {}
        for f in stats:
            for op, n in f.backend_ops.items():
                ops[op] = ops.get(op, 0) + n
            for name, sec in f.stage_s.items():
                stage_s[name] = stage_s.get(name, 0.0) + sec
        wait = sum(f.t_wait_s for f in stats)
        copy = sum(f.t_copy_s for f in stats)
        route = sum(f.t_route_s for f in stats)
        return {
            "beats": [f.beat for f in stats],
            "admitted": sum(f.n_admitted for f in stats),
            "dirty": sum(f.n_dirty for f in stats),
            "scan_path": one_path(f.scan_path for f in stats),
            "join_path": one_path(f.join_path for f in stats),
            "t_stage_s": sum(f.t_stage_s for f in stats),
            "t_dispatch_s": sum(f.t_dispatch_s for f in stats),
            "t_wait_s": wait, "t_kernel_s": wait,
            "t_copy_s": copy, "t_route_s": route,
            "t_collect_s": copy + route,
            "d2h_copies": sum(f.d2h_copies for f in stats),
            "copies_at_dispatch": sum(f.copies_at_dispatch for f in stats),
            "writes_held": sum(f.writes_held for f in stats),
            "stage_s": stage_s,
            "backend_ops": ops}

    def _collect_oldest(self) -> Dict[str, List[Ticket]]:
        """Collect the oldest flight: wait for its ``done`` event, read
        its results and route them.  With a mirror (one device) nothing
        else waits and nothing is copied from the device; a mesh
        generation's results are assembled and copied out here."""
        if not self._inflight:
            return {}
        flight = self._inflight.popleft()
        self._spilled_stats.append(flight)
        t0 = time.perf_counter()
        with self._range("repro.collect.wait"):
            if flight.done is not None:
                flight.done.synchronize()
        t_ready = time.perf_counter()
        with self._range("repro.collect.copy_out"):
            if flight.mirror is not None:
                # host memory that the beat's own copy filled
                res = flight.mirror.read()
                flight.copies_at_dispatch = 1
            else:
                # a mesh generation: its shards' results assembled and
                # copied out here (copies: the slot's buffers take a
                # later beat's results)
                res = flight.assemble(flight.results)
                flight.d2h_copies = sum(
                    torch.is_tensor(v) for v in res["_parts_rebuilt"].values())
                for name in flight.admitted:
                    res[name] = {k: v.to("cpu", copy=True).numpy()
                                 for k, v in res[name].items()}
                    flight.d2h_copies += len(res[name])
            self.last_overflow = int(res["_overflow"])
            self.last_delta_overflow = int(res["_delta_overflow"])
            self.last_parts_rebuilt = {
                t: bool(v) for t, v in res["_parts_rebuilt"].items()}
        t_copied = time.perf_counter()
        with self._range("repro.collect.route"):
            out = {}
            for name, tickets in flight.admitted.items():
                for slot, ticket in enumerate(tickets):
                    ticket.result = {k: v[slot]
                                     for k, v in res[name].items()}
                    ticket.done_time = t_copied
                out[name] = tickets
            for w in flight.writes:
                w.done_time = t_copied
        t_routed = time.perf_counter()
        flight.t_wait_s = t_ready - t0
        flight.t_copy_s = t_copied - t_ready
        flight.t_route_s = t_routed - t_copied
        if flight.marks:
            flight.stage_s = cg.stage_seconds(flight.marks)
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
        while len(done) < max_cycles and (self.pending() or self._inflight
                                          or self._spilled):
            while (self.pending() and dispatched < max_cycles
                   and len(self._inflight) < depth):
                self.dispatch()
                dispatched += 1
            if not self._inflight and not self._spilled:
                break       # budget exhausted with work still queued
            routed = self.collect()
            s = self.last_collect_stats
            done.append(CycleResult(
                tickets=routed, admitted=s["admitted"], dirty=s["dirty"],
                scan_path=s["scan_path"], join_path=s["join_path"],
                t_stage_s=s["t_stage_s"], t_dispatch_s=s["t_dispatch_s"],
                t_wait_s=s["t_wait_s"], t_copy_s=s["t_copy_s"],
                t_route_s=s["t_route_s"], t_collect_s=s["t_collect_s"],
                stage_s=s["stage_s"], backend_ops=s["backend_ops"]))
        return done

    # --------------------------------------------------- host-side fetch
    def snapshot(self, table: str) -> Dict[str, np.ndarray]:
        """Host copy of a table's columns/validity (the state is rolled
        forward in place); under a mesh in row order at the ORIGINAL
        (unpadded) capacity, whatever the layout."""
        if self._gen.spec is not None:
            return sharding.host_table(self._gen.spec, self.state, table)
        schema = self.plan.catalog.schemas[table]
        t = self.state[table]
        out = {c: t[c].to("cpu", copy=True).numpy() for c in schema.columns}
        out["_valid"] = t["_valid"].to("cpu", copy=True).numpy()
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
        snap = self.snapshot(table)
        out = {c: np.where(ids >= 0, snap[c][safe], 0) for c in cols}
        out["_row"] = ids
        return out
