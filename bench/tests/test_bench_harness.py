"""The benchmark's harness on the CPU: the frozen generator, the loops,
the drive loop against a stub engine, the metric arithmetic, and finding
cells, configurations, traffic, metrics and kernels by name.

Run with ``pytest bench/tests``."""
import collections
import json
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from bench import harness, stats  # noqa: E402
from bench.traffic import tpcw_gen  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def loop(name, params, seed, duration):
    mod = harness.load_module(harness.BENCH / "loops" / f"{name}.py")
    return mod.Loop(params, np.random.default_rng(seed), duration)


# ------------------------------------------------------------ generator
def test_generator_is_determined_by_its_seed():
    def draw(seed):
        rng = np.random.default_rng(seed)
        data = tpcw_gen.generate_data(rng, 128, 256)
        gen = tpcw_gen.WorkloadGenerator(rng, 128, 256)
        kinds = harness.exact_mix("ordering", 300, rng)
        return data, [(i.kind, i.queries, i.updates)
                      for i in map(gen.interaction, kinds)]
    (d1, i1), (d2, i2), (_, i3) = draw(7), draw(7), draw(8)
    assert all(np.array_equal(d1[t][c], d2[t][c]) for t in d1 for c in d1[t])
    assert i1 == i2
    assert i1 != i3


def test_exact_mix_holds_the_proportions_for_every_seed():
    a = collections.Counter(harness.exact_mix("shopping", 1000,
                                              np.random.default_rng(1)))
    b = collections.Counter(harness.exact_mix("shopping", 1000,
                                              np.random.default_rng(2)))
    assert a == b and sum(a.values()) == 1000
    assert a["search_request"] == 200 and a["home"] == 160


# ---------------------------------------------------------------- loops
def test_open_loop_offers_the_expected_count_in_order():
    a = loop("open_poisson", {"rate_per_s": 3840}, 1, 10.0)
    b = loop("open_poisson", {"rate_per_s": 3840}, 2, 10.0)
    assert a.needed() == b.needed() == 38400
    assert np.all(np.diff(a.offsets) >= 0)
    assert 0 <= a.offsets[0] and a.offsets[-1] < 10.0
    assert not np.array_equal(a.offsets, b.offsets)
    a.start(100.0)
    due = a.release(100.0 + 1.0)
    assert len(due) == int(np.sum(a.offsets <= 1.0))
    assert all(d <= 101.0 for d, _ in due)
    assert a.next_due() == pytest.approx(100.0 + a.offsets[len(due)])


def test_closed_pool_chains_each_client():
    lp = loop("closed_pool", {"clients": 3, "max_rate_per_s": 10}, 0, 2.0)
    lp.start(10.0)
    first = lp.release(10.0)
    assert sorted(c for _, c in first) == [0, 1, 2]
    assert all(d == 10.0 for d, _ in first)
    lp.completed(1, 10.2)                 # due again at its completion
    assert lp.next_due() == pytest.approx(10.2)
    assert lp.release(10.19) == []
    assert lp.release(10.3) == [(pytest.approx(10.2), 1)]
    lp.completed(0, 12.1)                 # past the end: it stops
    assert lp.release(20.0) == []


def test_closed_pool_refuses_to_run_past_its_generated_traffic():
    lp = loop("closed_pool", {"clients": 2, "max_rate_per_s": 0}, 0, 1.0)
    lp.start(0.0)
    lp.release(0.0)
    lp.completed(0, 0.1)
    with pytest.raises(RuntimeError, match="max_rate_per_s"):
        lp.release(1.0)


# ------------------------------------------------- the drive loop (stub)
class _Ticket:
    def __init__(self, i, template, params):
        self.id, self.template, self.params = i, template, params
        self.result = None


class _StubEngine:
    """Answers every query of a beat at its collect, 0.2 ms after; no
    device."""

    def __init__(self):
        self.queries, self.writes = [], []
        self.flights = collections.deque()
        self.last_collect_stats = {"t_stage_s": 0.001, "t_dispatch_s": 0.0,
                                   "t_collect_s": 0.001}
        self.last_overflow = 0
        self.last_scan_path, self.last_join_path = "full", ""
        self.beats = 0

    def pending(self):
        return len(self.queries) + len(self.writes)

    def dispatch(self):
        self.flights.append((self.queries, self.writes))
        self.queries, self.writes = [], []
        self.beats += 1

    def collect(self):
        time.sleep(0.0002)                 # a beat's device time
        queries, _ = self.flights.popleft()
        out = {}
        for t in queries:
            t.result = {"rows": np.zeros(1, np.int32)}
            out.setdefault(t.template, []).append(t)
        return out


class _StubServer:
    def __init__(self):
        self.engine = _StubEngine()
        self._ids = 0

    def submit(self, template, params):
        self._ids += 1
        t = _Ticket(self._ids, template, params)
        self.engine.queries.append(t)
        return t

    def submit_update(self, table, kind, payload):
        self.engine.writes.append((table, kind, payload))


def _interactions(n, mix="ordering"):
    rng = np.random.default_rng(5)
    gen = tpcw_gen.WorkloadGenerator(rng, 128, 256)
    return [gen.interaction(k) for k in harness.exact_mix(mix, n, rng)]


SLOTS = {"n_insert": 192, "n_update": 96, "n_delete": 96}


def test_drive_open_loop_times_from_the_due_time():
    lp = loop("open_poisson", {"rate_per_s": 400}, 4, 0.25)
    server = _StubServer()
    run = harness.Run(server, _interactions(lp.needed()), SLOTS, 2,
                      cuda=False)
    t0 = run.drive(lp, 1, 0.25)
    n = lp.needed()
    assert run.next == n and not np.isnan(run.done[:n]).any()
    np.testing.assert_allclose(run.due[:n], t0 + lp.offsets)
    assert np.all(run.sub[:n] >= run.due[:n])        # lateness >= 0
    assert np.all(run.done[:n] >= run.sub[:n])
    assert np.all(run.last_dispatch[:n] >= run.due[:n])
    # every write rode a beat and was acknowledged with it
    assert sum(len(b.writes) for b in run.beats) == sum(
        len(i.updates) for i in run.inter[:n])
    assert not run.owner and not run.inflight


def test_drive_closed_loop_chains_due_to_completion():
    lp = loop("closed_pool", {"clients": 4, "max_rate_per_s": 100000},
              0, 0.2)
    server = _StubServer()
    run = harness.Run(server, _interactions(lp.needed()), SLOTS, 2,
                      cuda=False)
    run.drive(lp, 1, 0.2)
    n = run.next
    assert n > 4
    by_client = collections.defaultdict(list)
    for i in range(n):
        by_client[run.client[i]].append(i)
    assert sorted(by_client) == [0, 1, 2, 3]
    for ids in by_client.values():
        for a, b in zip(ids, ids[1:]):
            assert run.due[b] == run.done[a]       # zero think time


def test_admission_mirror_caps_writes_per_table_and_kind():
    run = harness.Run(_StubServer(), [], {"n_insert": 2, "n_update": 1,
                                          "n_delete": 1}, 2, False)
    for k in range(5):
        run.wq.setdefault(("orders", "insert"), collections.deque()).append(
            (k, ("orders", "insert", {"o_id": k})))
    run.wq.setdefault(("customer", "update"), collections.deque()).extend(
        [(9, ("customer", "update", {})), (10, ("customer", "update", {}))])
    run.dispatch()
    assert [i for i, _ in run.beats[0].writes] == [0, 1, 9]
    run.dispatch()
    assert [i for i, _ in run.beats[1].writes] == [2, 3, 10]


# ----------------------------------------------------------- arithmetic
def test_percentiles_are_nearest_rank_over_all_values():
    v = list(range(1, 101))
    assert stats.pctl(v, 50) == 50 and stats.pctl(v, 95) == 95
    assert stats.pctl([3.0], 95) == 3.0
    # a failed interaction counts beyond every limit
    v = [10.0] * 94 + [stats.FAILED_MS] * 6
    assert stats.pctl(v, 95) == stats.FAILED_MS
    with pytest.raises(ValueError):
        stats.pctl([], 50)


def test_event_busy_time_and_idle_share():
    # beats in dispatch order: the second starts (by its event) before
    # the first ends; the third runs past the window
    spans = [(1.0, 4.0), (3.0, 6.0), (8.0, 12.0)]
    assert stats.beats_busy(spans, 10.0) == pytest.approx(3 + 2 + 2)
    rec = {"events_busy_s": 7.0, "events_window_s": 10.0}
    for name in ("device_idle_share.open", "device_idle_share.closed"):
        assert harness.metric_reader(name).read(rec) == pytest.approx(0.3)


def test_union_and_gaps():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0)]
    assert stats.union_s(iv) == 4.0
    assert stats.gaps(iv, -1.0, 7.0) == [(-1.0, 0.0), (3.0, 5.0), (6.0, 7.0)]


def test_backlog_and_rates():
    due = np.array([0.0, 1.0, 2.0, 3.0])
    done = np.array([0.5, np.nan, 2.5, 3.5])
    assert stats.backlog(due, done, [0.6, 2.0, 4.0]) == [0, 2, 1]
    rec = {"window_s": 10.0, "beats": 500, "host_s": 2.5,
           "cycles": {"full": 450, "delta": 40, "delta_join": 10}}
    read = harness.metric_reader
    assert read("beat_ms.open").read(rec) == 20.0
    assert read("host_ms_per_beat.closed").read(rec) == 5.0
    assert read("full_beat_share").read(rec) == 0.9


def test_roofline_readers_divide_least_by_device_time():
    rec = {"least_s": {"clockscan": 1.0, "fused_delta": None,
                       "shared_groupby": 2.0},
           "kernel_s": {"clockscan": 4.0, "fused_delta": 3.0,
                        "shared_groupby": 4.0}}
    read = harness.metric_reader
    assert read("clockscan_roofline.open").read(rec) == 25.0
    # a kernel whose least work is not counted stays out of the total
    assert read("kernel_roofline.open").read(rec) == pytest.approx(
        100 * 3 / 8)
    assert read("partitioned_join_roofline.closed").read(rec) is None


# -------------------------------------------------------------- lookups
def test_every_cell_finds_its_files_by_name():
    spec = harness.load_spec()
    for w in spec["workloads"]:
        cell = harness.find_cell(spec, w["name"])
        assert cell.config["name"] == w["config"]
        assert (harness.BENCH / "loops"
                / f"{cell.traffic['loop']}.py").is_file()
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert callable(harness.metric_reader(m["name"]).read)
    with pytest.raises(KeyError):
        harness.find_cell(spec, "no-such-cell")


def test_a_metric_finds_its_own_reader_before_its_base():
    m = harness.BENCH / "metrics"
    own = harness.metric_reader("full_beat_share")
    assert pathlib.Path(own.__file__) == m / "full_beat_share.py"
    for part in ("open", "closed"):
        mod = harness.metric_reader(f"beat_ms.{part}")
        assert pathlib.Path(mod.__file__) == m / "beat_ms.py"
    with pytest.raises(FileNotFoundError):
        harness.metric_reader("no_such_metric.open")


def test_benchmark_json_keeps_to_its_names_and_keys():
    spec = harness.load_spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in spec[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in spec["per_layer"]:
        if m["name"].endswith("roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    for c in spec["configs"]:
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert c["file"].startswith("bench/")


def test_roofline_files_count_each_kernel_by_name():
    files = harness.kernel_files()
    assert {"clockscan", "shared_groupby", "partitioned_join",
            "fused_delta"} <= set(files)
    spec = harness.load_spec()
    for name in ("tpcw10k-dense", "tpcw10k-indexless"):
        cfg = json.loads((harness.BENCH / "configs" / f"{name}.json")
                         .read_text())
        tables, templates = harness.schema.deployment(cfg)
        dep = harness.Deployment(tables, templates, cfg["dense_pk_index"])
        scan, bound = files["clockscan"].least_s(dep, "full")
        assert scan > 0 and bound == "bytes and int32 ops"
        assert files["clockscan"].least_s(dep, "delta") == (0.0, None)
        assert files["shared_groupby"].least_s(dep, "full")[0] > 0
        join = files["partitioned_join"].least_s(dep, "full")[0]
        assert (join > 0) != cfg["dense_pk_index"]
        assert files["fused_delta"].least_s(dep, "delta") == (None, None)
    assert spec["paths"] == ["bench"]


def test_run_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    r = subprocess.run(
        [sys.executable, str(harness.BENCH / "run.py"), "--workload",
         "tpcw10k-dense.shopping.p80", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=harness.ROOT)
    assert r.returncode == 3
    assert "correct" not in r.stdout
    assert "CUDA device" in r.stderr

