"""Port, pipelined dispatch/collect on the CPU: the port's tickets equal
the reference's query-at-a-time answers (``repro.core.baseline``, on the
same data from the same seed and scale) through both places a beat's
results leave the device: behind the beat at dispatch, into its pipeline
slot's host mirror (one device, ``mirror``), and at collect (a mesh
generation, here of one shard, ``collect``).  A beat's tickets keep its
answers when its slot runs again."""
import numpy as np
import pytest
import torch

from repro.core.baseline import QueryAtATimeEngine
from repro.workloads import tpcw as ref_tpcw
from repro_torch.core.executor import SharedDBEngine
from repro_torch.core.sharding import make_row_mesh
from repro_torch.workloads import tpcw

SCALE_I, SCALE_C = 400, 1200
SEED = 3

#: where the port's results are copied out: at dispatch (the mirror) or
#: at collect (a one-shard mesh generation)
PATHS = ["mirror", "collect"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's ops at these sizes gain nothing from intra-op threads
    (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def worlds():
    """``(engine, baseline, generator)`` by ``PATHS`` name, each built on
    first use: the port's engine on the CPU and the reference's
    query-at-a-time engine, on the data of one seed."""
    built = {}

    def get(path):
        if path not in built:
            rng = np.random.default_rng(SEED)
            data = tpcw.generate_data(rng, SCALE_I, SCALE_C)
            mesh = make_row_mesh(1, devices=["cpu"]) \
                if path == "collect" else None
            eng = SharedDBEngine(
                tpcw.build_tpcw_plan(SCALE_I, SCALE_C),
                tpcw.DEFAULT_UPDATE_SLOTS, data, kernels="torch",
                device="cpu", mesh=mesh)
            baseline = QueryAtATimeEngine(
                ref_tpcw.build_tpcw_plan(SCALE_I, SCALE_C),
                tpcw.generate_data(np.random.default_rng(SEED),
                                   SCALE_I, SCALE_C))
            built[path] = (eng, baseline,
                           tpcw.WorkloadGenerator(rng, SCALE_I, SCALE_C))
        return built[path]
    return get


def _copied_at_dispatch(eng, path):
    """On one device every beat a collect took came from its host
    mirror, one copy a beat; at collect, none did."""
    s = eng.last_collect_stats
    want = len(s["beats"]) if path == "mirror" else 0
    assert s["copies_at_dispatch"] == want, s["beats"]
    if path == "mirror":
        assert s["d2h_copies"] == want


def _compare(t, r2):
    if "rows" in t.result:
        a = set(int(x) for x in np.asarray(t.result["rows"]) if x >= 0)
        b = set(int(x) for x in np.asarray(r2["rows"]) if x >= 0)
        assert a == b, (t.template, t.params, sorted(a)[:5], sorted(b)[:5])
    else:
        np.testing.assert_allclose(np.sort(np.asarray(t.result["scores"])),
                                   np.sort(np.asarray(r2["scores"])),
                                   rtol=1e-6)


@pytest.mark.parametrize("path", PATHS)
def test_pipelined_port_equals_query_at_a_time(worlds, path):
    """The port's shared plan through the pipelined path answers as the
    reference's per-query plans do, on a stable snapshot."""
    eng, baseline, gen = worlds(path)
    inters = gen.sample_mix("shopping", 40)
    for it in inters:  # stable snapshot: updates first
        for u in it.updates:
            eng.submit_update(*u)
            baseline.apply_update(*u)
    eng.run_until_drained(pipelined=True)
    tickets = []
    for it in inters:
        for q in it.queries:
            tickets.append(eng.submit(*q))
    eng.run_until_drained(pipelined=True)
    assert not eng.in_flight()
    _copied_at_dispatch(eng, path)
    assert all(t.result is not None for t in tickets)
    for t in tickets:
        _compare(t, baseline.execute(t.template, t.params).result)


@pytest.mark.parametrize("path", PATHS)
def test_port_dispatch_collect_equals_run_cycle(worlds, path):
    """Explicit dispatch()/collect() routes the same results as the
    synchronous run_cycle() wrapper, and as the reference's
    query-at-a-time plan."""
    eng, baseline, _ = worlds(path)
    item = 13
    t_sync = eng.submit("get_related", {0: (item, item)})
    eng.run_cycle()
    t_split = eng.submit("get_related", {0: (item, item)})
    eng.dispatch()
    assert eng.in_flight() == 1
    assert t_split.done_time is None       # not routed until collect
    out = eng.collect()
    _copied_at_dispatch(eng, path)
    assert t_split in out["get_related"]
    assert t_split.done_time is not None
    assert (np.asarray(t_sync.result["rows"])
            == np.asarray(t_split.result["rows"])).all()
    _compare(t_split, baseline.execute(t_split.template,
                                       t_split.params).result)


def _storages(tree):
    return {t.untyped_storage().data_ptr()
            for t in torch.utils._pytree.tree_leaves(tree)
            if torch.is_tensor(t) and t.numel()}


class _StorageReads(torch.utils._python_dispatch.TorchDispatchMode):
    """The storages of every tensor argument of the ops run inside."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen |= _storages((args, kwargs or {}))
        return func(*args, **(kwargs or {}))


def test_tickets_keep_their_beats_answers_when_the_slot_reruns(worlds):
    """Depth 2: beats n and n+1 dispatched, n collected, then n+2 and
    n+4 run on n's slot and are collected.  Beat n's tickets keep beat
    n's answers (equal to the reference's query-at-a-time answers),
    although its slot's host mirror now holds beat n+4's; no collect
    reads a buffer of the device (results, rid carry, state, scan
    carry), and every collected beat came from the mirror."""
    eng, baseline, _ = worlds("mirror")
    assert eng.pipeline_depth == 2 and len(eng._gen.mirrors) == 2
    device = _storages((eng._gen.results, eng.state, eng._gen.carry))
    reads = _StorageReads()

    def beat(i):
        ts = [eng.submit("get_book", {0: (i, i)}),
              eng.submit("get_customer", {0: (i, i)})]
        eng.dispatch()
        return ts

    def collect():
        with reads:
            eng.collect()
        _copied_at_dispatch(eng, "mirror")

    while eng.in_flight():
        eng.collect()
    slot = eng._staging_idx
    n = beat(3)
    beat(4)
    collect()                                  # n
    kept = [{k: v.copy() for k, v in t.result.items()} for t in n]
    assert beat(5) and eng._inflight[-1].slot == slot     # n+2
    collect()
    collect()
    beat(6)
    n4 = beat(7)                               # n+4, on n's slot again
    assert eng._inflight[-1].slot == slot
    collect()
    collect()
    assert not reads.seen & device
    mirror = eng._gen.mirrors[slot].read()
    for t, k, t4 in zip(n, kept, n4):
        for key, v in k.items():
            np.testing.assert_array_equal(t.result[key], v)
            np.testing.assert_array_equal(mirror[t.template][key][0],
                                          t4.result[key])
        assert not np.array_equal(t.result["rows"], t4.result["rows"])
        _compare(t, baseline.execute(t.template, t.params).result)
