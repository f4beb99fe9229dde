"""One run of one benchmark cell: set-up, a warm-up of traffic, the
measured window, the drain, the check against the plain reference, and
the metrics.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration file, its traffic file ``bench/traffic/<traffic>.json``
and that file's loop ``bench/loops/<loop>.py``, each per-layer metric's
reader ``bench/metrics/<name>.py`` (or, for ``<base>.<part>``, the
reader ``<base>.py`` that its parts share), and each hand kernel's
symbol and least work ``bench/roofline/<kernel>.py``.

A traced run (``--trace 1``) serves the same untraced window as any
other run and reads the host-side metrics (spans, stamps, events,
counters) from it; then it serves a second, shorter window under the
profiler, from which it reads only what the device trace holds.

The window drives ``repro_torch``'s SharedDB engine as its clients see
it: interactions of the TPC-W generator (``bench/traffic/tpcw_gen.py``)
are submitted through ``QueryCycleServer.submit`` / ``submit_update`` as
they fall due, and beats run through the engine's ``dispatch()`` /
``collect()``, at most ``pipeline_depth`` in flight, so no beat is ever
collected inside ``dispatch()``.  One thread does it all: before each
``dispatch()`` it submits every interaction due by then.

An interaction's latency runs from its due time to the ``collect()``
that answers its last query, or that acknowledges its writes if that
comes later: a write is acknowledged when the beat that carried it has
been collected.  No public call says which beat carried a write, so the
harness follows the engine's documented admission rule: at each
``dispatch()`` the queued writes of each table and kind go in arrival
order, up to the configuration's update slots.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import pathlib
import shutil
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from bench import stats
from bench.reference import schema
from bench.reference.tpcw_ref import Reference

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
# top-level module names the timed process may not hold: the JAX package
# and JAX itself (``repro_torch`` is another name, compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# how long the drain may wait for the last answers past the window
DRAIN_S = 60.0
# the longest window a traced run serves and traces
TRACE_WINDOW_S = 10.0
SLOT_OF = {"insert": "n_insert", "update": "n_update", "delete": "n_delete"}


# ------------------------------------------------------------ lookups
def load_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_module(path: pathlib.Path):
    """A file of the benchmark loaded by its path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict               # the cell's entry in BENCHMARK.json
    config: dict              # its configuration file
    traffic: dict             # its traffic file
    end_to_end: List[dict]
    per_layer: List[dict]


def metric_reader(name: str):
    """The reader of per-layer metric ``name``: ``bench/metrics/<name>.py``,
    else the file of its name without its last dotted part."""
    path = BENCH / "metrics" / f"{name}.py"
    if not path.is_file() and "." in name:
        path = BENCH / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    return load_module(path)


def find_cell(spec: dict, name: str) -> Cell:
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r}; cells: {sorted(cells)}")
    entry = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((ROOT / configs[entry["config"]]["file"])
                        .read_text())
    traffic = json.loads((BENCH / "traffic" / f"{entry['traffic']}.json")
                         .read_text())
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in moved
                                  else [])]
    return Cell(name, entry, config, traffic, e2e, per_layer)


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the timed process may not
    hold, each compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Deployment:
    tables: Dict[str, schema.Table]
    templates: Dict[str, schema.Template]
    dense_pk_index: bool


def kernel_files() -> Dict[str, object]:
    """Hand kernel name -> its ``bench/roofline`` module."""
    mods = {p.stem: load_module(p)
            for p in sorted((BENCH / "roofline").glob("*.py"))}
    return {k: m for k, m in mods.items() if hasattr(m, "SYMBOL")}


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "nvidia-smi: not found"
    try:
        out = subprocess.run(
            [smi, "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except subprocess.TimeoutExpired:
        return "nvidia-smi: timed out"
    return out.stdout.strip().replace("\n", " | ")


# ------------------------------------------------------------- the run
class _Beat:
    __slots__ = ("phase", "t_d0", "ev0", "ev1", "host_s",
                 "spans", "queries", "writes", "flavour")

    def __init__(self, phase: int):
        self.phase = phase
        self.queries = []     # (interaction, template, params, result)
        self.writes = []      # (interaction, (table, kind, payload))
        self.ev0 = self.ev1 = None
        self.host_s = 0.0
        self.spans = (0.0, 0.0, 0.0, 0.0)


class Run:
    """The state of one run's traffic over the program."""

    def __init__(self, server, interactions, slots: dict, depth: int,
                 cuda: bool):
        import torch
        self.torch = torch
        self.server = server
        self.eng = server.engine
        self.inter = interactions
        self.slots = slots
        self.depth = depth
        self.cuda = cuda
        # profiler ranges mark the harness's steps (set in a traced window)
        self.trace = False
        n = len(interactions)
        self.due = np.full(n, np.nan)
        self.sub = np.full(n, np.nan)
        self.done = np.full(n, np.nan)
        self.last_dispatch = np.full(n, np.nan)
        self.phase_of = np.full(n, -1, np.int8)
        self.client = [None] * n
        self.out_q = np.zeros(n, np.int32)
        self.out_w = np.zeros(n, np.int32)
        # ticket id -> (interaction, its query's index)
        self.owner: Dict[int, tuple] = {}
        self.wq = collections.OrderedDict()    # (table, kind) -> deque
        self.next = 0
        self.beats: List[_Beat] = []
        self.inflight: collections.deque = collections.deque()
        self.overflow_beats = 0
        self.longest_step = 0.0       # the loop's longest step, seconds
        self.loop = None
        self.phase = -1

    def _range(self, name):
        if self.trace:
            return self.torch.autograd.profiler.record_function(name)
        return contextlib.nullcontext()

    def submit(self, due: float, client, now: float) -> None:
        i = self.next
        if i >= len(self.inter):
            raise RuntimeError("the schedule ran past the interactions "
                               "generated in set-up")
        self.next += 1
        it = self.inter[i]
        self.due[i], self.sub[i] = due, now
        self.client[i] = client
        self.phase_of[i] = self.phase
        for k, (name, params) in enumerate(it.queries):
            self.owner[self.server.submit(name, params).id] = (i, k)
        for w in it.updates:
            self.server.submit_update(*w)
            self.wq.setdefault(w[:2], collections.deque()).append((i, w))
        self.out_q[i] = len(it.queries)
        self.out_w[i] = len(it.updates)

    def dispatch(self) -> None:
        beat = _Beat(self.phase)
        # the engine's admission rule: each table's and kind's queued
        # writes in arrival order, up to the update slots of a beat
        for (table, kind), q in self.wq.items():
            for _ in range(min(len(q), self.slots[SLOT_OF[kind]])):
                beat.writes.append(q.popleft())
        with self._range("bench.dispatch"):
            if self.cuda:
                beat.ev0 = self.torch.cuda.Event(enable_timing=True)
                beat.ev0.record()
            beat.t_d0 = time.perf_counter()
            self.eng.dispatch()
            if self.cuda:
                beat.ev1 = self.torch.cuda.Event(enable_timing=True)
                beat.ev1.record()
        e = self.eng
        beat.flavour = "full" if e.last_scan_path == "full" else (
            "delta_join" if e.last_join_path == "delta" else "delta")
        self.beats.append(beat)
        self.inflight.append(beat)

    def oldest_done(self) -> bool:
        return not self.cuda or self.inflight[0].ev1.query()

    def _complete(self, i: int, t: float) -> None:
        self.done[i] = t
        if self.phase_of[i] == self.phase:
            self.loop.completed(self.client[i], t)

    def collect(self) -> None:
        beat = self.inflight.popleft()
        with self._range("bench.collect"):
            routed = self.eng.collect()
            t = time.perf_counter()
        s = self.eng.last_collect_stats
        beat.host_s = s["t_stage_s"] + s["t_dispatch_s"] + s["t_collect_s"]
        beat.spans = (s["t_stage_s"], s["t_dispatch_s"],
                      s.get("t_kernel_s", 0.0), s["t_collect_s"])
        self.overflow_beats += self.eng.last_overflow > 0
        for name, tickets in routed.items():
            for tk in tickets:
                i, k = self.owner.pop(tk.id)
                want, params = self.inter[i].queries[k]
                # the query as the benchmark made it; routed under another
                # template's name, its answer is judged wrong
                beat.queries.append((i, want, params,
                                     tk.result if name == want else None))
                self.last_dispatch[i] = beat.t_d0
                self.out_q[i] -= 1
                if self.out_q[i] == 0 and self.out_w[i] == 0:
                    self._complete(i, t)
        for i, _ in beat.writes:
            self.out_w[i] -= 1
            if self.out_w[i] == 0 and self.out_q[i] == 0:
                self._complete(i, t)

    def drive(self, loop, phase: int, duration: float,
              on_end: Optional[Callable] = None,
              on_start: Optional[Callable] = None) -> float:
        """Serve one phase of ``duration`` seconds of traffic, then drain
        it; returns the phase's start time.  ``on_start`` runs just
        before the start, ``on_end`` at the first step past its end."""
        self.loop, self.phase = loop, phase
        if on_start is not None:
            on_start()
        t0 = time.perf_counter()
        loop.start(t0)
        t_end, ended = t0 + duration, False
        eng, depth = self.eng, self.depth
        prev = t0
        while True:
            now = time.perf_counter()
            if now - prev > self.longest_step:
                self.longest_step = now - prev
            prev = now
            if not ended and now >= t_end:
                ended = True
                if on_end is not None:
                    on_end()
            due = loop.release(now)
            if due:
                with self._range("bench.submit"):
                    for d, client in due:
                        self.submit(d, client, now)
            if ended and (now > t_end + DRAIN_S or (
                    not self.inflight and not eng.pending()
                    and loop.next_due() == math.inf)):
                return t0
            if self.inflight and self.oldest_done():
                self.collect()
            elif eng.pending() and len(self.inflight) < depth:
                self.dispatch()
            elif len(self.inflight) >= depth:
                self.collect()
            elif not self.inflight:
                wait = min(loop.next_due(), t_end) - now
                if wait > 0:
                    with self._range("bench.idle"):
                        time.sleep(min(wait, 0.002))


def exact_mix(mix: str, n: int, rng: np.random.Generator) -> List[str]:
    """``n`` interaction kinds in the mix's exact proportions (largest
    remainders), in an order drawn from ``rng``: every seed serves the
    same set of interactions."""
    from bench.traffic.tpcw_gen import MIXES
    kinds = list(MIXES[mix])
    p = np.array([MIXES[mix][k] for k in kinds], float)
    want = p / p.sum() * n
    count = np.floor(want).astype(int)
    count[np.argsort(-(want - count), kind="stable")[:n - count.sum()]] += 1
    seq = np.repeat(np.arange(len(kinds)), count)
    return [kinds[i] for i in rng.permutation(seq)]


def _lateness(run: Run, sel) -> str:
    late = (run.sub[sel] - run.due[sel]) * 1e3
    if late.size == 0:
        return "none"
    return (f"p50 {np.percentile(late, 50):.4f} ms, p99 "
            f"{np.percentile(late, 99):.4f} ms, max {late.max():.4f} ms")


def judge(run: Run, ref: Reference, control: Optional[Reference] = None):
    """Every answered query against the reference, beat by beat (each
    beat's writes first), and, with ``control``, the control's answers
    in place of the program's.  Returns (wrong answers, unanswered
    queries, the control's wrong answers or None)."""
    wrong, ctl_wrong = 0, 0 if control is not None else None
    for beat in run.beats:
        writes = [w for _, w in beat.writes]
        if control is not None:
            # the control reads the state before its beat's writes
            ctl = [control.answer(name, params)
                   for _, name, params, _ in beat.queries]
            control.apply_beat(writes)
        ref.apply_beat(writes)
        for k, (_, name, params, got) in enumerate(beat.queries):
            want = ref.answer(name, params)
            if not _same(got, want):
                wrong += 1
            if control is not None and not _same(ctl[k], want):
                ctl_wrong += 1
    return wrong, len(run.owner), ctl_wrong


def checks_of(wrong: int, unanswered: int, readback: int) -> dict:
    """The numbers that decide ``correct``, each beside its limit (all
    exact: limit 0)."""
    return {"wrong_answers": {"value": wrong, "limit": 0},
            "unanswered_queries": {"value": unanswered, "limit": 0},
            "readback_mismatches": {"value": readback, "limit": 0}}


def passes(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def _same(got, want) -> bool:
    if got is None or set(got) != set(want):
        return False
    return all(np.array_equal(np.asarray(got[k]), want[k]) for k in want)


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device=None, overrides: Optional[dict] = None,
             engine_hook: Optional[Callable] = None, control: bool = False,
             out=print) -> dict:
    """One run of ``cell_name``; returns the result object.

    ``device=None`` is the CUDA card.  ``overrides`` replaces keys of the
    configuration (and ``traffic.<key>`` keys of the traffic file), and
    ``engine_hook(engine)`` runs on the built engine: both serve tests
    and the rate sweep, never a measured run.  ``control`` also judges
    the control (a reference that reads each beat's state before its
    writes) in the program's place, by the same checks and limits, under
    the result's ``control`` key."""
    spec = load_spec()
    cell = find_cell(spec, cell_name)
    cfg = dict(cell.config)
    traffic = dict(cell.traffic)
    for k, v in (overrides or {}).items():
        if k.startswith("traffic."):
            traffic[k[len("traffic."):]] = v
        else:
            cfg[k] = v
    def part(name, t):
        out(f"setup {name}_s {t:.6f}")

    t = time.perf_counter()
    import torch
    from repro_torch.core.executor import SharedDBEngine
    from repro_torch.core.storage import UpdateSlots
    from repro_torch.serving.query_server import QueryCycleServer
    from repro_torch.workloads import tpcw
    from bench.traffic import tpcw_gen
    part("imports", time.perf_counter() - t)
    cuda = device is None or str(device).startswith("cuda")
    if cuda:
        out(f"card {card_line()}")

    t = time.perf_counter()
    ss = np.random.SeedSequence(int(seed) % 2 ** 64)
    rng_data, rng_mix, rng_warm, rng_win, rng_traced = [
        np.random.default_rng(s) for s in ss.spawn(5)]
    si, sc = cfg["scale_items"], cfg["scale_customers"]
    data = tpcw_gen.generate_data(rng_data, si, sc)
    part("data", time.perf_counter() - t)

    t = time.perf_counter()
    plan = tpcw.build_tpcw_plan(si, sc, max_results=cfg["max_results"],
                                headroom=cfg["headroom"],
                                dense_pk_index=cfg["dense_pk_index"])
    slots = cfg["update_slots"]
    eng = SharedDBEngine(plan, UpdateSlots(**slots), data,
                         kernels=cfg["kernels"], device=device,
                         pipeline_depth=cfg["pipeline_depth"],
                         jit=cfg["graphed"])
    if engine_hook is not None:
        engine_hook(eng)
    server = QueryCycleServer(eng)
    if cuda:
        torch.cuda.synchronize()
    t_engine = time.perf_counter() - t
    cap = eng.capture_stats[0] if eng.capture_stats else {}
    part("engine", t_engine)
    out(f"setup engine: gate_s {sum(eng.gate_s):.6f} warmup_s "
        f"{cap.get('warmup_s', 0.0):.6f} capture_s "
        f"{cap.get('capture_s', 0.0):.6f} graphs {cap.get('graphs', 0)} "
        f"graphed {eng.graphed}")

    t = time.perf_counter()
    tables, templates = schema.deployment(cfg)
    dep = Deployment(tables, templates, cfg["dense_pk_index"])
    ref = Reference(tables, templates, data, cfg["max_results"])
    ctl = Reference(tables, templates, data, cfg["max_results"]) \
        if control else None
    part("reference_tables", time.perf_counter() - t)

    t = time.perf_counter()
    loop_mod = load_module(BENCH / "loops" / f"{traffic['loop']}.py")
    warm = loop_mod.Loop(traffic, rng_warm, traffic["warmup_s"])
    win = loop_mod.Loop(traffic, rng_win, seconds)
    # a traced run's second window: the trace takes ~5 s a second to stop
    # and read
    traced_s = min(seconds, TRACE_WINDOW_S)
    traced = loop_mod.Loop(traffic, rng_traced, traced_s) if trace else None
    gen = tpcw_gen.WorkloadGenerator(rng_mix, si, sc)
    inter = [gen.interaction(k) for k in exact_mix(
        traffic["mix"], warm.needed() + win.needed()
        + (traced.needed() if trace else 0), rng_mix)]
    part("traffic", time.perf_counter() - t)

    run = Run(server, inter, slots, cfg["pipeline_depth"], cuda)
    # the harness keeps every answer for the judge, as no server would: the
    # collector's passes over them (and over the generated traffic) are the
    # harness's cost, so it does not run while traffic is served
    gc.collect()
    gc.freeze()
    gc.disable()
    t = time.perf_counter()
    run.drive(warm, 0, traffic["warmup_s"])
    part("traffic_warmup", time.perf_counter() - t)

    kfiles = kernel_files()
    from repro_torch import kernels as K

    def counters():
        return {"launches": dict(K.LAUNCHES), "full": eng.full_cycles,
                "delta": eng.delta_cycles,
                "delta_join": eng.delta_join_cycles}

    def marks(prof=None):
        """(mark, on_start, on_end) of one window: counters, the host
        clock and CUDA events at its ends, and with ``prof``, the
        profiler started before it and its range."""
        mark = {}

        def on_start():
            if prof is not None:
                t = time.perf_counter()
                prof.start()
                part("profiler_start", time.perf_counter() - t)
                mark["range"] = torch.autograd.profiler.record_function(
                    "bench.window")
                mark["range"].__enter__()
            if cuda:
                mark["ev0"] = torch.cuda.Event(enable_timing=True)
                mark["ev0"].record()
            mark["c0"] = counters()

        def on_end():
            mark["c1"] = counters()
            mark["t_end"] = time.perf_counter()
            if cuda:
                mark["ev1"] = torch.cuda.Event(enable_timing=True)
                mark["ev1"].record()
            if prof is not None:
                mark["range"].__exit__(None, None, None)
        return mark, on_start, on_end

    mark, on_start, on_end = marks()
    run.longest_step = 0.0
    T0 = run.drive(win, 1, seconds, on_end=on_end, on_start=on_start)
    t_drained = time.perf_counter()
    mark["T0"] = T0
    tmark = prof = None
    if trace:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        tmark, t_on, t_off = marks(prof)
        run.trace = True
        tmark["T0"] = run.drive(traced, 2, traced_s, on_end=t_off,
                                on_start=t_on)
        t = time.perf_counter()
        # stopped once the window's answers are in: stopping takes seconds
        prof.stop()
        tmark["prof_stop_s"] = time.perf_counter() - t
    gc.enable()
    found = forbidden_modules()
    if found:
        raise SystemExit(f"the timed process holds modules {found}: the "
                         "benchmark may not load JAX or the JAX package")
    setup_s = T0 - t_start
    out(f"setup total_s {setup_s:.6f} (process start to the window's "
        "first due arrival)")
    mem = torch.cuda.max_memory_allocated() if cuda else 0
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"

    # ---- the window's interactions
    sel = run.phase_of == 1
    kinds = [it.kind for it in inter]
    timeout = np.array([tpcw_gen.WI_TIMEOUT[k] for k in kinds])
    lat_ms = np.where(np.isnan(run.done), stats.FAILED_MS,
                      (run.done - run.due) * 1e3)
    in_time = lat_ms <= timeout * 1e3
    attempted = int(sel.sum())
    failed = int((sel & ~in_time).sum())
    t_end = mark["t_end"]
    wips = float((sel & in_time & (run.done <= t_end)).sum()) / seconds
    lat_w = lat_ms[sel].tolist()
    wb = window_beats(run, mark)
    out(f"window: {attempted} interactions due, {failed} failed, "
        f"{len([b for b in run.beats if b.phase == 1])} beats, drain "
        f"{t_drained - t_end:.6f} s; generator lateness "
        f"{_lateness(run, sel)}; union-cap overflow in "
        f"{run.overflow_beats} beats; longest harness step "
        f"{run.longest_step * 1e3:.4f} ms")
    quarters = [T0 + seconds * q for q in (0.25, 0.5, 0.75, 1.0)]
    out("window backlog at 1/4, 1/2, 3/4, 4/4: "
        f"{stats.backlog(run.due[sel], run.done[sel], quarters)}")
    if wb:
        mean = np.mean([b.spans for b in wb], axis=0) * 1e3
        out(f"window engine spans ms a beat (last_collect_stats): stage "
            f"{mean[0]:.4f} dispatch {mean[1]:.4f} device wait "
            f"{mean[2]:.4f} collect {mean[3]:.4f}; beats by path "
            f"{dict(collections.Counter(b.flavour for b in wb))}")
    if lat_w:
        out(f"window latency ms: p50 {stats.pctl(lat_w, 50):.4f} p95 "
            f"{stats.pctl(lat_w, 95):.4f} p99 {stats.pctl(lat_w, 99):.4f} "
            f"max {max(lat_w):.4f}; completed in window {wips:.4f}/s")

    # ---- per-layer reading (device side first, before anything is freed)
    rec = None
    if trace:
        rec = _layer_record(run, mark, tmark, sel, dep, kfiles, cuda, prof)
        out(f"trace: profiler busy {rec['trace']['busy_s']:.6f} s of "
            f"{rec['trace']['window_s']:.6f} s traced; events busy "
            f"{rec['events_busy_s']:.6f} s of {rec['events_window_s']:.6f} "
            f"s untraced, {rec['traced_events_busy_s']:.6f} s of "
            f"{rec['traced_events_window_s']:.6f} s traced; "
            f"{rec['trace']['device_events']} device events; beats "
            f"{rec['beats']} untraced, {rec['traced_beats']} traced; stop "
            f"{tmark['prof_stop_s']:.3f} s, read {rec['read_s']:.3f} s; "
            f"kept kernel events "
            f"{ {k: v[0] for k, v in rec['trace']['kernels'].items()} } "
            f"of launches {rec['launches']}")

    # ---- correctness: read back, free the program, then the reference
    snaps = {name: eng.snapshot(name) for name in tables}
    del server, eng, run.server, run.eng
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    wrong, unanswered, ctl_wrong = judge(run, ref, ctl)
    readback = sum(ref.readback_mismatches(n, s) for n, s in snaps.items())
    out(f"reference: {sum(len(b.queries) for b in run.beats)} answers over "
        f"{len(run.beats)} beats judged in {time.perf_counter() - t:.3f} s")
    checks = checks_of(wrong, unanswered, readback)
    correct = passes(checks)

    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = metric_reader(m["name"]).read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"setup_s": setup_s, "wips": wips}
        if lat_w:
            values["wi_p50_ms"] = stats.pctl(lat_w, 50)
            values["wi_p95_ms"] = stats.pctl(lat_w, 95)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu", "kind": kind,
                         "count": int(cell.entry["chips"]),
                         "memory_peak_bytes": int(mem)}}
    if trace:
        result["device"]["busy_s"] = rec["trace"]["busy_s"]
        result["device"]["window_s"] = rec["trace"]["window_s"]
        result["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                               "idle_gaps": rec["trace"]["idle_gaps"]}
    if ctl is not None:
        # the control in the program's place: the same answers judged, and
        # its own tables read back at the program's capacities
        ctl_checks = checks_of(ctl_wrong, unanswered, sum(
            ref.readback_mismatches(n, ctl.t[n].snapshot(tables[n].capacity))
            for n in tables))
        result["control"] = {"correct": passes(ctl_checks),
                             "checks": ctl_checks}
    result["checks"] = checks
    return result


def window_beats(run: Run, mark: dict) -> List[_Beat]:
    """The beats dispatched inside one window."""
    return [b for b in run.beats if mark["T0"] <= b.t_d0 < mark["t_end"]]


def _events_busy(mark: dict, beats: List[_Beat]) -> tuple:
    """(busy, window) seconds of one window by the CUDA events on the
    serving stream."""
    ev0, ev1 = mark["ev0"], mark["ev1"]
    ev1.synchronize()
    window_ms = ev0.elapsed_time(ev1)
    busy_ms = stats.beats_busy(
        [(ev0.elapsed_time(b.ev0), ev0.elapsed_time(b.ev1)) for b in beats],
        window_ms)
    return busy_ms / 1e3, window_ms / 1e3


def _delta(mark: dict) -> tuple:
    """(beats by flavour, hand-kernel launches) over one window."""
    c0, c1 = mark["c0"], mark["c1"]
    cycles = {"full": c1["full"] - c0["full"],
              "delta_join": c1["delta_join"] - c0["delta_join"]}
    cycles["delta"] = c1["delta"] - c0["delta"] - cycles["delta_join"]
    launches = {k: c1["launches"].get(k, 0) - c0["launches"].get(k, 0)
                for k in c1["launches"]}
    return cycles, launches


def _layer_record(run: Run, mark: dict, tmark: dict, sel, dep,
                  kfiles: dict, cuda: bool, prof) -> dict:
    """What the per-layer readers read: the host's spans, stamps, CUDA
    events and counters over the untraced window (``mark``), and the
    device trace with its counters over the traced one (``tmark``)."""
    from bench import trace as tr
    win, traced = window_beats(run, mark), window_beats(run, tmark)
    cycles, _ = _delta(mark)
    t_cycles, launches = _delta(tmark)
    busy = window = t_busy = t_window = 0.0
    if cuda:
        busy, window = _events_busy(mark, win)
        t_busy, t_window = _events_busy(tmark, traced)
    t = time.perf_counter()
    symbols = {k: m.SYMBOL for k, m in kfiles.items()}
    trace = tr.read(prof, symbols)
    read_s = time.perf_counter() - t
    kernel_s, least_s = {}, {}
    for k, (kept, secs) in trace["kernels"].items():
        if kept and launches.get(k, 0):
            kernel_s[k] = secs / kept * launches[k]
    for k, m in kfiles.items():
        total = 0.0
        for flavour, n in t_cycles.items():
            s, _ = m.least_s(dep, flavour)
            if s is None:
                total = None
                break
            total += n * s
        least_s[k] = total
    admit = np.where(np.isnan(run.last_dispatch[sel]), stats.FAILED_MS,
                     (run.last_dispatch[sel] - run.due[sel]) * 1e3)
    return {
        # the untraced window
        "window_s": mark["t_end"] - mark["T0"], "beats": len(win),
        "host_s": sum(b.host_s for b in win), "cycles": cycles,
        "admit_wait_ms": admit.tolist(), "events_busy_s": busy,
        "events_window_s": window,
        # the traced window
        "traced_beats": len(traced), "launches": launches,
        "kernel_s": kernel_s, "least_s": least_s, "trace": trace,
        "traced_events_busy_s": t_busy, "traced_events_window_s": t_window,
        "read_s": read_s}
