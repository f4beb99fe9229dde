"""The engine's own records as the benchmark's tools read them, on the CPU:
idle gaps credited to the innermost of nested host ranges
(``bench/ranges.py``), ``bench/stages.py``'s window summary, with and
without the records a traced engine adds, and the harness's mirror of
the engine's admission rule against the beat each ``WriteTicket``
names.

Run with ``pytest bench/tests``."""
import collections
import pathlib
import sys
import time

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from bench import harness, ranges, stages  # noqa: E402
from bench.traffic import tpcw_gen  # noqa: E402

TINY = {"scale_items": 128, "scale_customers": 256, "kernels": "torch",
        "graphed": False, "traffic.warmup_s": 0.3, "traffic.rate_per_s": 150,
        "traffic.clients": 12}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread at these sizes (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------ nested ranges
def test_innermost_names_each_piece_by_the_range_opened_last():
    rs = [(0, 10, "bench.dispatch"), (2, 4, "repro.dispatch.admit"),
          (6, 8, "repro.dispatch.launch"), (12, 14, "bench.collect"),
          (12, 13, "repro.collect.wait")]
    assert ranges.innermost(rs) == [
        (0, 2, "bench.dispatch"), (2, 4, "repro.dispatch.admit"),
        (4, 6, "bench.dispatch"), (6, 8, "repro.dispatch.launch"),
        (8, 10, "bench.dispatch"), (12, 13, "repro.collect.wait"),
        (13, 14, "bench.collect")]


def test_a_gap_is_split_over_the_ranges_it_crosses():
    rs = [(0, 10, "bench.dispatch"), (6, 8, "repro.dispatch.launch"),
          (12, 14, "bench.collect")]
    got = ranges.credit([(5, 7), (9, 13), (20, 21)], rs)
    assert got == {"bench.dispatch": 2, "repro.dispatch.launch": 1,
                   "bench.collect": 1, ranges.UNCOVERED: 3}


def test_ranges_that_follow_one_another_credit_as_before():
    rs = [(0, 2, "bench.submit"), (2, 5, "bench.dispatch"),
          (6, 9, "bench.collect")]
    got = ranges.credit([(1, 3), (5, 7), (8.5, 9.5)], rs)
    assert got == {"bench.submit": 1, "bench.dispatch": 1,
                   "bench.collect": 1.5, ranges.UNCOVERED: 1.5}
    assert ranges.credit([(0, 1)], []) == {ranges.UNCOVERED: 1}


# ------------------------------------------------- the window summary
def test_a_record_without_the_traced_keys_reads_as_missing():
    """The parent engine's ``last_collect_stats``: no wait / copy / route
    split, no copies, no held writes, no stages, no acknowledgements."""
    p = stages.Probe()
    p.dispatched = [(1.0, None, None), (2.0, None, None)]
    p.collected = [{"t_stage_s": 0.001, "t_dispatch_s": 0.001,
                    "t_collect_s": 0.002, "beats": [k]} for k in (0, 1)]
    got = p.window(0.5, 2.5)
    assert got == {"beats": 2, "host_ms_per_beat": pytest.approx(4.0),
                   "beat_ms": pytest.approx(1000.0),
                   "collect_ms": pytest.approx(2.0)}
    p.collected = [{"t_stage_s": 0.0, "t_dispatch_s": 0.0,
                    "t_collect_s": 0.0}]
    assert p.window(0.5, 2.5) == {"beats": 0}
    assert stages.group_ms({}) == {}


def test_stage_groups_put_sorts_and_routes_together():
    got = stages.group_ms({"apply": 1.0, "scan:item": 2.0, "scan:fused": 1.0,
                           "join:a.b.c": 0.5, "sort:item.i_title": 3.0,
                           "route:item": 1.0, "groupby:order_line": 0.25,
                           "commit": 0.125})
    assert got == {"apply": 1.0, "scan": 3.0, "join": 0.5, "route": 4.0,
                   "groupby": 0.25, "commit": 0.125}


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_a_traced_engine_reports_its_stages_through_the_harness(trace):
    """One run of the ordering pool at a test's size with the engine
    tracing: every beat of the window names its stages, collect's split
    adds up, writes carry their admission, and a traced run credits idle
    time to the engine's own ranges inside the harness's (the window
    opens with a dispatch; a collect may fall past its 1 s end on a
    loaded machine, so only the launch is asked for)."""
    r = stages.run_one("tpcw10k-indexless.ordering.pool256", 17, 1.0, "on",
                       trace, device="cpu", overrides=TINY)
    w = r["window"]
    assert r["correct"] and w["beats"] > 0
    assert set(w["stage_group_ms"]) == set(stages.GROUPS)
    assert w["stage_group_ms"]["route"] > 0
    assert w["collect_ms"] == pytest.approx(w["copy_ms"] + w["route_ms"])
    assert w["d2h_copies_per_beat"] > 0
    assert w["write_admit_wait_p95_ms"] >= 0
    if trace:
        names = {n for n, _ in r["idle_gaps_innermost"]}
        assert "repro.dispatch.launch" in names


# ---------------------------------------- the harness's admission mirror
class _Loop:
    def completed(self, client, t):
        pass


def test_the_harness_mirror_assigns_each_write_the_beat_its_ticket_names():
    """Ordering-mix interactions against 2 / 1 / 1 update slots, so writes
    queue for several beats: the beat the harness's mirror of the
    admission rule puts each write in is the beat its ``WriteTicket``
    names."""
    from repro_torch.core.executor import SharedDBEngine
    from repro_torch.core.storage import UpdateSlots
    from repro_torch.serving.query_server import QueryCycleServer
    from repro_torch.workloads import tpcw

    rng = np.random.default_rng(5)
    data = tpcw_gen.generate_data(rng, 128, 256)
    plan = tpcw.build_tpcw_plan(128, 256, max_results=64, headroom=1.0,
                                dense_pk_index=False)
    slots = {"n_insert": 2, "n_update": 1, "n_delete": 1}
    eng = SharedDBEngine(plan, UpdateSlots(**slots), data, kernels="torch",
                         device="cpu", jit=False, trace=True)
    server = QueryCycleServer(eng)
    acks, first_beat = {}, {}
    submit = server.submit_update

    def keep(table, kind, payload):
        acks[id(payload)] = submit(table, kind, payload)
        first_beat[id(payload)] = len(run.beats)
        return acks[id(payload)]
    server.submit_update = keep
    gen = tpcw_gen.WorkloadGenerator(rng, 128, 256)
    inter = [gen.interaction(k)
             for k in harness.exact_mix("ordering", 60, rng)]
    run = harness.Run(server, inter, slots, 2, cuda=False)
    run.loop, run.phase = _Loop(), 1
    for k in range(len(inter)):
        run.submit(float(k), None, time.perf_counter())
        if k % 3 == 2:
            if len(run.inflight) >= 2:
                run.collect()
            run.dispatch()
    while eng.pending() or run.inflight:
        if run.inflight and (len(run.inflight) >= 2 or not eng.pending()):
            run.collect()
        else:
            run.dispatch()
    by_beat = collections.Counter()
    for b, beat in enumerate(run.beats):
        for _, (_, _, payload) in beat.writes:
            assert acks[id(payload)].beat == b
            by_beat[b] += 1
    assert sum(by_beat.values()) == len(acks) > 0
    assert all(w.done_time is not None for w in acks.values())
    # some writes waited behind the slots for a later beat
    assert any(w.beat > first_beat[k] for k, w in acks.items())
