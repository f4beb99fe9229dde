"""The engine's tracing on the CPU (``SharedDBEngine(trace=True)``).

  * stage marks: every collected beat's ``stage_s`` names each lowered
    stage once, in plan order, between the body's ``start`` and
    ``commit`` marks, each >= 0; with ``trace=False`` no mark sink opens
    and ``stage_s`` is ``{}``;
  * host spans: ``t_collect_s`` is copy + route, and ``d2h_copies``
    counts the result copies: one a beat, queued at dispatch, whose
    results the collect reads from the host mirror
    (``copies_at_dispatch``);
  * beats: tickets and write acknowledgements carry the sequence number
    of the dispatch that admitted them, writes FIFO per table and kind
    behind the update slots (``writes_held`` counts those left queued);
  * the pipeline: a slot is never run again while a flight on it is
    uncollected (a captured graph's mark events are read at collect);
  * a mesh engine refuses ``trace=True``.

On the CPU a mark stamps ``perf_counter`` (eager bodies run
synchronously); the card's event marks are ``tests/test_torch_cuda.py``'s.
"""
import collections
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import backends as tb
from repro_torch.core import graphs as cg
from repro_torch.core.executor import SharedDBEngine
from repro_torch.core.sharding import make_row_mesh
from repro_torch.core.storage import UpdateSlots
from repro_torch.serving.query_server import QueryCycleServer
from repro_torch.workloads import tpcw

SCALE_I, SCALE_C = 64, 128
CHAINED = "torch-chained-trace-test"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Ops at these sizes gain nothing from intra-op threads; one thread
    keeps this module from oversubscribing the cores that parallel test
    workers share (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine(dense=True, slots=tpcw.DEFAULT_UPDATE_SLOTS, kernels="torch",
            **kw):
    plan = tpcw.build_tpcw_plan(SCALE_I, SCALE_C, dense_pk_index=dense)
    data = tpcw.generate_data(np.random.default_rng(0), SCALE_I, SCALE_C)
    return SharedDBEngine(plan, slots, data, kernels=kernels, device="cpu",
                          **kw)


def _full_stages(lowered):
    """A full beat's stage names in plan order (``lowering``'s marks)."""
    return (["apply"] + [f"scan:{s.table}" for s in lowered.scans]
            + ["join:" + ".".join(j.key) for j in lowered.joins]
            + [f"sort:{s.spine}.{s.col}" for s in lowered.sorts]
            + [f"groupby:{g.spine}" for g in lowered.groups]
            + [f"route:{r.spine}" for r in lowered.routes] + ["commit"])


def _submit_beat(eng, beat):
    eng.submit_update("customer", "update", {
        "key": 3 + beat, "col": "c_expiration", "val": 900 + beat})
    return [eng.submit("get_book", {0: (5, 5)}),
            eng.submit("get_cart", {0: (12, 12)}),
            eng.submit("best_sellers", {0: (0, 40), 1: (1, 3)})]


@pytest.mark.parametrize("kind", ["dense", "indexless", "chained"])
def test_stage_marks_name_every_lowered_stage_in_plan_order(kind):
    """``chained``: index-less on the torch ops without fused_delta."""
    tb.register_backend(dataclasses.replace(
        tb.get_backend("torch"), name=CHAINED, fused_delta=None))
    eng = _engine(kind == "dense", trace=True,
                  kernels=CHAINED if kind == "chained" else "torch")
    lowered = eng._lowered
    full = _full_stages(lowered)
    scans = full[1:1 + len(lowered.scans)]
    post = full[1 + len(lowered.scans):]

    def delta():
        # a delta beat scans in the fused op, or in the stages' panes and
        # then the chained dirty-row op; with carried rids the chained
        # path probes every partitioned join's dirty rows before the joins
        if kind != "chained":
            return ["apply", "scan:fused"] + post
        probe = ["join:delta"] if eng.last_join_path == "delta" else []
        return ["apply"] + scans + ["scan:delta"] + probe + post
    seen = []
    for beat in range(4):
        _submit_beat(eng, beat)
        eng.run_cycle()
        s = eng.last_collect_stats
        want = full if eng.last_scan_path == "full" else delta()
        assert list(s["stage_s"]) == want, (beat, eng.last_scan_path)
        assert all(v >= 0.0 for v in s["stage_s"].values())
        assert s["t_collect_s"] == pytest.approx(s["t_copy_s"]
                                                 + s["t_route_s"])
        assert s["t_wait_s"] == s["t_kernel_s"] >= 0.0
        # every template's results and the flags in one packed copy
        assert s["d2h_copies"] == s["copies_at_dispatch"] == 1
        seen.append(eng.last_scan_path)
    assert seen[0] == "full" and "delta" in seen


def test_trace_off_opens_no_sink_and_records_no_stage(monkeypatch):
    opened = []
    real = cg.MarkSink.__init__

    def spy(self, *a, **kw):
        opened.append(1)
        real(self, *a, **kw)
    monkeypatch.setattr(cg.MarkSink, "__init__", spy)
    eng = _engine()
    for beat in range(3):
        _submit_beat(eng, beat)
        done = eng.run_until_drained(pipelined=True)
        assert all(d.stage_s == {} for d in done)
        assert eng.last_collect_stats["stage_s"] == {}
    assert not opened and not eng.trace


def test_tickets_carry_their_beat_in_dispatch_order():
    eng = _engine(trace=True)
    by_beat = []
    for beat in range(5):
        ts = _submit_beat(eng, beat)
        eng.dispatch()
        by_beat.append(ts)
        if len(eng._inflight) == 2:
            eng.collect()
    eng.collect()
    eng.collect()
    ids = [t.beat for ts in by_beat for t in ts]
    assert ids == sorted(ids) and [ts[0].beat for ts in by_beat] == [
        0, 1, 2, 3, 4]
    for ts in by_beat:
        for t in ts:
            assert t.submit_time <= t.admit_time <= t.done_time


def test_writes_queue_fifo_per_table_and_kind_behind_the_slots():
    """Five inserts and three deletes of ``customer`` and four updates of
    ``item`` a beat against 2 / 1 / 1 slots: each (table, kind) is
    admitted in submission order, up to its slots a beat, and acknowledged
    by the collect of its beat."""
    slots = UpdateSlots(n_insert=2, n_update=1, n_delete=1)
    eng = _engine(slots=slots, trace=True)
    server = QueryCycleServer(eng)
    acks = collections.defaultdict(list)
    for i in range(5):
        acks["customer", "insert"].append(server.submit_update(
            "customer", "insert", {"c_id": 1000 + i, "c_uname": 1}))
    for i in range(3):
        acks["customer", "delete"].append(server.submit_update(
            "customer", "delete", {"key": 10 + i}))
    for i in range(4):
        acks["item", "update"].append(server.submit_update(
            "item", "update", {"key": 7 + i, "col": "i_cost", "val": i}))
    held = []
    while eng.pending():
        eng.run_cycle()
        held.append(eng.last_collect_stats["writes_held"])
    per_beat = {"insert": 2, "update": 1, "delete": 1}
    for (table, kind), ws in acks.items():
        assert [w.beat for w in ws] == [k // per_beat[kind]
                                        for k in range(len(ws))]
        assert all(w.submit_time <= w.admit_time <= w.done_time
                   for w in ws)
        assert all(w.table == table and w.kind == kind for w in ws)
    # 12 writes: 4 admitted in each of the first two beats, then 3, 1
    assert held == [8, 4, 1, 0]


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_no_slot_runs_again_before_its_flight_is_collected(depth):
    """The graphs are per (flavour, slot), so a slot's mark events are
    recorded again only by its next beat: every flight in the pipeline
    sits on a slot of its own, whatever the depth."""
    eng = _engine(pipeline_depth=depth, trace=True)
    assert len(eng._gen.staging) >= depth
    for beat in range(2 * depth + 3):
        _submit_beat(eng, beat)
        eng.dispatch()
        slots = [f.slot for f in eng._inflight]
        assert len(slots) == len(set(slots)) <= depth, (beat, slots)
        collected = eng.last_collect_stats["beats"]
        assert all(b < beat for b in collected)
    while eng.in_flight():
        eng.collect()


def test_a_mesh_engine_refuses_to_trace():
    plan = tpcw.build_tpcw_plan(SCALE_I, SCALE_C)
    with pytest.raises(NotImplementedError, match="mesh"):
        SharedDBEngine(plan, tpcw.DEFAULT_UPDATE_SLOTS, {}, kernels="torch",
                       mesh=make_row_mesh(2, devices=["cpu"] * 2),
                       trace=True)


def test_stage_seconds_times_each_stage_from_the_mark_before():
    marks = [("start", 1.0), ("apply", 1.5), ("scan:a", 1.75),
             ("scan:a", 2.0), ("commit", 2.5)]
    assert cg.stage_seconds(marks) == {"apply": 0.5, "scan:a": 0.5,
                                       "commit": 0.5}
    assert cg.stage_seconds([]) == {} == cg.stage_seconds([("start", 0.0)])
