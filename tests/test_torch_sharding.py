"""Port parity, the sharded heartbeat: ``SharedDBEngine(mesh=...)`` of
``repro_torch`` (core/sharding.py) on row meshes of ``["cpu"] * S``, at
scale 64/128 (the reference's ``tests/test_sharded_engine.py`` scale).

  * S = 1 is bit-identical to the port's unsharded engine: the same
    result arrays in the same order, the same scan / join paths and
    backend launches a beat, the same snapshots — dense and index-less
    catalogs, fused and chained delta beats;
  * S = 2 and 4, on ``torch`` and ``hopper`` (whose wrappers run their
    plain versions on CPU tensors), and S = 2 on the chained ops: ticket
    and snapshot parity with the port's ``QueryAtATimeEngine`` over the
    reference's deterministic index-less stream — carried-rid beats, a
    PK-write fallback beat, a wide beat through every merge, a
    dirty-overflow reseed — and the indexed world;
  * once per module, the same stream agrees ticket for ticket with the
    reference's unsharded ``SharedDBEngine`` (rows as sets, group scores
    within rtol 1e-6);
  * the counterparts of the reference's sort-merge, key-mirror,
    alignment-padding and pipelined-drain tests;
  * a fold under S = 2 through ``QueryCycleServer`` equals a cold S = 2
    engine built with the final template set, and a fold that adds a
    mirrored table is refused with ``fold-mirror-set`` (the reference's
    finding);
  * ``lint --shards 2 --device cpu`` exits 0, and ``make_row_mesh(n)``
    without devices raises on a machine with fewer than n cards.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.analysis_static import ir_passes as rpasses
from repro.core.executor import SharedDBEngine as RefEngine
from repro.core.plan import Join as RJoin
from repro.core.plan import Pred as RPred
from repro.core.plan import QueryTemplate as RTemplate
from repro.core.plan import compile_plan as ref_compile
from repro.workloads import tpcw as ref_tpcw
from repro_torch.analysis_static import ir_passes as tpasses
from repro_torch.core import backends as tb
from repro_torch.core import sharding
from repro_torch.core.baseline import QueryAtATimeEngine
from repro_torch.core.executor import SharedDBEngine
from repro_torch.core.plan import Join, Pred, QueryTemplate, compile_plan
from repro_torch.core.storage import Catalog, TableSchema, UpdateSlots
from repro_torch.serving import QueryCycleServer
from repro_torch.workloads import tpcw

SCALE_I, SCALE_C = 64, 128
INT_MAX = tpcw.INT_MAX
CHAINED = "torch-chained-sharding-test"
tb.register_backend(dataclasses.replace(tb.get_backend("torch"),
                                        name=CHAINED, fused_delta=None))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Ops at scale 64/128 gain nothing from intra-op threads; one thread
    keeps this module from oversubscribing the cores that parallel test
    workers share (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mesh(n):
    return sharding.make_row_mesh(n, ["cpu"] * n)


def _data():
    return tpcw.generate_data(np.random.default_rng(0), SCALE_I, SCALE_C)


def _compare(tag, got, want):
    """One ticket's answer: rows as sets, group scores sorted within rtol
    1e-6."""
    if "rows" in want:
        g, w = np.asarray(got["rows"]), np.asarray(want["rows"])
        assert set(g[g >= 0].tolist()) == set(w[w >= 0].tolist()), tag
    else:
        np.testing.assert_allclose(
            np.sort(np.asarray(got["scores"]).ravel()),
            np.sort(np.asarray(want["scores"]).ravel()), rtol=1e-6,
            err_msg=str(tag))


class _ShardedWorld:
    """One sharded port engine and the port's query-at-a-time oracle,
    compared ticket for ticket and snapshot for snapshot every heartbeat;
    with ``ref``, the reference's unsharded engine too."""

    def __init__(self, shards, backend, dense_pk_index=False, ref=False):
        data = _data()
        self.plan = tpcw.build_tpcw_plan(SCALE_I, SCALE_C,
                                         dense_pk_index=dense_pk_index)
        self.eng = SharedDBEngine(self.plan, tpcw.DEFAULT_UPDATE_SLOTS,
                                  data, kernels=backend, mesh=mesh(shards))
        self.base = QueryAtATimeEngine(self.plan, data, device="cpu")
        self.ref = None if not ref else RefEngine(
            ref_tpcw.build_tpcw_plan(SCALE_I, SCALE_C,
                                     dense_pk_index=dense_pk_index),
            ref_tpcw.DEFAULT_UPDATE_SLOTS, data, jit=True, kernels="jnp")
        self.pending_updates, self.pending_queries = [], []
        self.next_item = SCALE_I

    def queue_update(self, update):
        self.pending_updates.append(update)
        self.eng.submit_update(*update)
        if self.ref is not None:
            self.ref.submit_update(*update)

    def insert_item(self, subject, cost):
        i = self.next_item
        self.next_item += 1
        self.queue_update(("item", "insert", {
            "i_id": i, "i_a_id": i % max(SCALE_I // 4, 1),
            "i_subject": subject, "i_title": i % tpcw.N_TITLE_TOKENS,
            "i_pub_date": 11500, "i_cost": cost, "i_srp": cost + 100,
            "i_stock": 5, "i_related1": 0}))

    def submit(self, name, params):
        self.pending_queries.append(
            (name, params, self.eng.submit(name, params),
             None if self.ref is None else self.ref.submit(name, params)))

    def heartbeat(self, pipelined=False):
        for u in self.pending_updates:
            self.base.apply_update(*u)
        self.pending_updates = []
        self.eng.run_until_drained(pipelined=pipelined)
        if self.ref is not None:
            self.ref.run_until_drained(pipelined=pipelined)
            assert (self.eng.last_scan_path, self.eng.last_join_path) == \
                (self.ref.last_scan_path, self.ref.last_join_path)
        for name, params, ticket, rticket in self.pending_queries:
            assert ticket.result is not None, name
            _compare(("oracle", name, params), ticket.result,
                     self.base.execute(name, params).result)
            if rticket is not None:
                _compare(("reference", name, params), ticket.result,
                         {k: np.asarray(v)
                          for k, v in rticket.result.items()})
        self.pending_queries = []
        for table in self.plan.catalog.schemas:
            got = self.eng.snapshot(table)
            want = self.base.state[table]
            for col in list(self.plan.catalog.schemas[table].columns) + \
                    ["_valid"]:
                np.testing.assert_array_equal(
                    got[col], want[col].numpy(), err_msg=(table, col))


def _drive_deterministic_stream(w):
    """The reference's stream (tests/test_sharded_engine.py): seed ->
    PK-write fallback -> carried-rid beats -> a wide beat (sort, group
    and route merges, pipelined) -> dirty-overflow reseed -> recovery."""
    rng = np.random.default_rng(7)

    def submit_joins(o_id):
        w.submit("order_lines", {0: (o_id, o_id)})
        w.submit("get_cart", {0: (12, 12)})
        w.submit("get_book", {0: (5, 5)})

    submit_joins(10)
    w.heartbeat()
    assert w.eng.last_scan_path == "full"
    w.queue_update(("item", "update", {
        "key": int(rng.integers(0, SCALE_I)), "col": "i_cost",
        "val": int(rng.integers(100, 9999))}))
    submit_joins(11)
    w.heartbeat()
    assert w.eng.last_join_path == "full"
    for beat in range(3):
        w.queue_update(("customer", "update", {
            "key": int(rng.integers(0, SCALE_C)), "col": "c_expiration",
            "val": int(rng.integers(12000, 15000))}))
        submit_joins(20 + beat)
        w.heartbeat()
    assert w.eng.delta_join_cycles >= 2
    w.insert_item(3, 999)
    w.submit("best_sellers", {0: (0, INT_MAX), 1: (4, 4)})
    w.submit("order_display", {0: (9, 9)})
    w.submit("get_customer", {0: (5, 5)})
    w.submit("search_subject", {0: (2, 2)})
    w.submit("new_products", {0: (3, 3)})
    w.heartbeat(pipelined=True)
    dirty_cap = w.plan.catalog.schemas["item"].dirty_cap
    n_upd = min(tpcw.DEFAULT_UPDATE_SLOTS.n_update, dirty_cap)
    for k in range(n_upd):
        w.queue_update(("item", "update",
                        {"key": k, "col": "i_stock", "val": 1}))
    for k in range(n_upd, dirty_cap + 1):
        w.queue_update(("item", "delete", {"key": k}))
    submit_joins(30)
    w.heartbeat()
    assert w.eng.last_scan_path == "full"
    assert w.eng.last_delta_overflow == 0
    w.queue_update(("customer", "update",
                    {"key": 1, "col": "c_expiration", "val": 14999}))
    submit_joins(31)
    w.heartbeat()
    assert w.eng.last_join_path == "delta"


@pytest.mark.parametrize("shards,backend", [
    (2, "torch"), (4, "torch"), (2, "hopper"), (4, "hopper"),
    (2, CHAINED)])
def test_sharded_differential_indexless_stream(shards, backend):
    """Ticket and snapshot parity with the port's oracle over the
    index-less stream: every join on a carried access path, every beat
    class at this shard count and backend."""
    _drive_deterministic_stream(_ShardedWorld(shards, backend))


def test_sharded_stream_agrees_with_the_reference_engine():
    """Once per module: a 2-shard port engine on ``hopper`` and the
    reference's unsharded engine through the same stream take the same
    paths every beat and agree ticket for ticket."""
    _drive_deterministic_stream(_ShardedWorld(2, "hopper", ref=True))


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_differential_indexed_world(shards):
    """Dense-index catalog (every join a gather): sharded spines merge
    exactly against the oracle; slot-stable admission stays on the
    delta path."""
    w = _ShardedWorld(shards, "torch", dense_pk_index=True)
    rng = np.random.default_rng(5)
    for beat in range(3):
        w.queue_update(("customer", "update", {
            "key": int(rng.integers(0, SCALE_C)), "col": "c_expiration",
            "val": int(rng.integers(12000, 15000))}))
        w.submit("admin_item", {0: (3, 3)})
        w.submit("get_customer", {0: (int(rng.integers(0, SCALE_C)),) * 2})
        w.submit("order_lines", {0: (7, 7)})
        w.heartbeat()
    assert w.eng.delta_cycles >= 1


def _mesh1_stream(eng):
    """(results, paths, backend ops, snapshots) of each beat of a stream
    of full, delta, carried-join, insert and delete beats."""
    subs = [("admin_item", {0: (3, 3)}), ("get_customer", {0: (5, 5)}),
            ("search_subject", {0: (2, 2)}), ("order_lines", {0: (7, 7)}),
            ("get_cart", {0: (12, 12)}),
            ("best_sellers", {0: (0, INT_MAX), 1: (4, 4)}),
            ("order_display", {0: (9, 9)}), ("new_products", {0: (3, 3)})]
    out = []
    for beat in range(4):
        if beat == 1:
            eng.submit_update("customer", "update",
                              {"key": 2, "col": "c_expiration",
                               "val": 14999})
        if beat == 2:
            eng.submit_update("item", "update",
                              {"key": 5, "col": "i_cost", "val": 1234})
            eng.submit_update("item", "insert", {
                "i_id": SCALE_I + 1, "i_a_id": 1, "i_subject": 2,
                "i_title": 3, "i_pub_date": 11500, "i_cost": 500,
                "i_srp": 600, "i_stock": 5, "i_related1": 0})
            eng.submit_update("customer", "delete", {"key": 7})
        tickets = [(n, eng.submit(n, p)) for n, p in subs]
        res = eng.run_until_drained()
        out.append(((eng.last_scan_path, eng.last_join_path),
                    res[-1].backend_ops,
                    [(n, t.result) for n, t in tickets],
                    {t: eng.snapshot(t) for t in eng.plan.catalog.schemas}))
    return out


@pytest.mark.parametrize("dense,backend", [
    (True, "torch"), (False, "torch"), (False, CHAINED)])
def test_mesh1_bit_identical_to_unsharded_engine(dense, backend):
    """At one shard the sharded engine reproduces the unsharded one bit
    for bit: result arrays (order and dtype included), paths and backend
    launches every beat, snapshots."""
    plan = tpcw.build_tpcw_plan(SCALE_I, SCALE_C, dense_pk_index=dense)
    runs = [_mesh1_stream(SharedDBEngine(
        plan, tpcw.DEFAULT_UPDATE_SLOTS, _data(), kernels=backend, **kw))
        for kw in ({"device": "cpu"}, {"mesh": mesh(1)})]
    for beat, (want, got) in enumerate(zip(*runs)):
        assert got[0] == want[0] and got[1] == want[1], beat
        for (name, g), (_, w) in zip(got[2], want[2]):
            assert sorted(g) == sorted(w)
            for k in w:
                assert g[k].dtype == w[k].dtype, (beat, name, k)
                np.testing.assert_array_equal(g[k], w[k],
                                              err_msg=(beat, name, k))
        for table, cols in want[3].items():
            for k in cols:
                np.testing.assert_array_equal(got[3][table][k], cols[k],
                                              err_msg=(beat, table, k))


def test_sharded_sort_merge_exact_on_sharded_spine():
    """A sort stage on a row-sharded spine (none in TPC-W): duplicate
    keys spread over 4 shards merge in exact global order — ties break
    by shard, then local row, which is global row order."""
    T = 64
    cat = Catalog([TableSchema("t", ("k", "g", "v"), T, pk="k")])
    tpl = [QueryTemplate("q", "t", preds=(Pred("t", "g"),), sort_col="v",
                         limit=10),
           QueryTemplate("qd", "t", preds=(Pred("t", "g"),), sort_col="v",
                         sort_desc=True, limit=10)]
    plan = compile_plan(cat, tpl, {"q": 8, "qd": 8}, max_results=16)
    rng = np.random.default_rng(1)
    data = {"t": {"k": np.arange(T), "g": rng.integers(0, 3, T),
                  "v": rng.integers(0, 4, T)}}
    eng = SharedDBEngine(plan, UpdateSlots(4, 4, 4), data, kernels="torch",
                         mesh=mesh(4))
    base = QueryAtATimeEngine(plan, data, device="cpu")
    for g in (0, 1, 2):
        ta = eng.submit("q", {0: (g, g)})
        tq = eng.submit("qd", {0: (g, g)})
        eng.run_until_drained()
        for name, t in (("q", ta), ("qd", tq)):
            want = base.execute(name, {0: (g, g)}).result["rows"]
            np.testing.assert_array_equal(t.result["rows"], want,
                                          err_msg=(name, g))


def test_sharded_key_mirror_tracks_pk_rewrites_and_batch_order():
    """The (key, valid) locate mirror of an index-less row-sharded PK
    table tracks pk-column rewrites and the delete-then-update arrival
    order of one batch."""
    T = 16
    cat = Catalog([TableSchema("t", ("k", "v"), T, pk="k")])
    tpl = [QueryTemplate("byk", "t", preds=(Pred("t", "k"),), limit=4)]
    plan = compile_plan(cat, tpl, {"byk": 8}, max_results=8)
    data = {"t": {"k": np.arange(T) * 10, "v": np.arange(T)}}
    eng = SharedDBEngine(plan, UpdateSlots(4, 4, 4), data, kernels="torch",
                         mesh=mesh(2))
    base = QueryAtATimeEngine(plan, data, device="cpu")

    def beat(updates, q_key):
        for u in updates:
            eng.submit_update(*u)
            base.apply_update(*u)
        t = eng.submit("byk", {0: (q_key, q_key)})
        eng.run_until_drained()
        want = base.execute("byk", {0: (q_key, q_key)}).result["rows"]
        np.testing.assert_array_equal(t.result["rows"], want)
        snap = eng.snapshot("t")
        for c in ("k", "v", "_valid"):
            np.testing.assert_array_equal(snap[c], base.state["t"][c].numpy())

    beat([("t", "update", {"key": 30, "col": "k", "val": 77})], 77)
    beat([("t", "update", {"key": 77, "col": "v", "val": 999})], 77)
    beat([("t", "delete", {"key": 50}),
          ("t", "update", {"key": 50, "col": "v", "val": 123})], 50)
    beat([("t", "insert", {"k": 50, "v": 5})], 50)
    # two updates of one cell in one batch: the later wins, as unsharded
    beat([("t", "update", {"key": 110, "col": "v", "val": 1}),
          ("t", "update", {"key": 110, "col": "v", "val": 2})], 110)


def test_insert_overflow_never_lands_in_alignment_padding():
    """A capacity not divisible by the shard count pads each shard with
    alignment rows; inserts past the ORIGINAL capacity are dropped as the
    unsharded engine drops them, never committed into the padding."""
    T = 10                                  # ceil(10 / 4) * 4 = 12
    cat = Catalog([TableSchema("t", ("k", "v"), T, pk="k")])
    tpl = [QueryTemplate("byv", "t", preds=(Pred("t", "v"),), limit=T)]
    plan = compile_plan(cat, tpl, {"byv": 8}, max_results=16)
    data = {"t": {"k": np.arange(8) * 10, "v": np.zeros(8, np.int64)}}
    eng = SharedDBEngine(plan, UpdateSlots(4, 4, 4), data, kernels="torch",
                         mesh=mesh(4))
    base = QueryAtATimeEngine(plan, data, device="cpu")
    for i in range(4):
        u = ("t", "insert", {"k": 100 + i, "v": 0})
        eng.submit_update(*u)
        base.apply_update(*u)
    t = eng.submit("byv", {0: (0, 0)})
    eng.run_until_drained()
    want = base.execute("byv", {0: (0, 0)}).result["rows"]
    got = t.result["rows"]
    np.testing.assert_array_equal(got, want)
    assert got[got >= 0].max() <= T - 1
    snap = eng.snapshot("t")
    for c in ("k", "v", "_valid"):
        np.testing.assert_array_equal(snap[c], base.state["t"][c].numpy())
    assert snap["_n"] == 12                 # the cursor still advances
    spec = eng._gen.spec
    assert spec.padded["t"] == 12 and spec.shard_rows["t"] == 3
    # the alignment rows (global 10, 11: shard 3's last two) stay invalid
    assert not eng.state[3]["t"]["_valid"][1:].any()


def test_sharded_pipelined_drain_matches_oracle():
    """Double-buffered dispatch / collect over the mesh: each slot's
    staged copies, results and merged buffers stay intact until
    collected."""
    w = _ShardedWorld(2, "torch")
    rng = np.random.default_rng(9)
    for beat in range(3):
        w.queue_update(("customer", "update", {
            "key": int(rng.integers(0, SCALE_C)), "col": "c_expiration",
            "val": 13000 + beat}))
        w.submit("get_book", {0: (beat, beat)})
        w.submit("get_customer", {0: (beat, beat)})
        w.heartbeat(pipelined=True)


def test_sharded_state_layout():
    """Padded capacities divide by S; each shard's leaves are tensors of
    their own; a row-sharded table's side state is per shard and aliases
    no column leaf; mirrors are full tables; dirty sets sentinel Ts."""
    plan = tpcw.build_tpcw_plan(SCALE_I, SCALE_C, dense_pk_index=False)
    spec = sharding.build_shard_spec(plan, mesh(4))
    state = sharding.init_sharded_state(spec, _data())
    assert set(spec.mirrored) == {j.pk_table for j in plan.joins}
    ptrs = set()
    for shard in state:
        for name, t in shard.items():
            schema = plan.catalog.schemas[name]
            assert spec.padded[name] % 4 == 0
            assert spec.padded[name] >= schema.capacity
            rows = spec.rows(name)
            assert t["_valid"].shape == (rows,)
            if not spec.is_mirrored(name):
                assert int(t["_dirty_rows"][0]) == rows
                assert set(t) >= set(schema.columns) | {"_n", "_version"} \
                    | set(sharding._STACKED_KEYS)
                side = set(t) & set(sharding._SIDE_KEYS)
                assert side == {"_n", "_version"} | (
                    {"_pk_index"} if schema.indexed else
                    {"_mkey", "_mvalid"} if schema.pk else set())
            for k, v in t.items():
                if v.numel():
                    p = v.untyped_storage().data_ptr()
                    assert p not in ptrs, (name, k)
                    ptrs.add(p)
    snap = sharding.host_table(spec, state, "customer")
    data = _data()["customer"]
    n = len(data["c_id"])
    np.testing.assert_array_equal(snap["c_id"][:n], data["c_id"])
    assert snap["_valid"][:n].all() and not snap["_valid"][n:].any()


# ------------------------------------------------------------- folding
FOLD_BATCH = ("order_lines", "order_display", "get_cart")


def _split(final=False, address=False):
    """(templates by name, caps, plan): the reference's fold split (10
    base templates), or the final set compiled cold."""
    catalog = tpcw.make_catalog(SCALE_I, SCALE_C, dense_pk_index=False)
    templates, caps = tpcw.make_templates(catalog.schemas["item"].capacity)
    names = [t.name for t in templates]
    keep = names if final else [n for n in names if n not in FOLD_BATCH]
    plan = compile_plan(catalog, [t for t in templates if t.name in keep],
                        {n: caps[n] for n in keep})
    return {t.name: t for t in templates}, caps, plan


def buy_request_address():
    return QueryTemplate("buy_request_address", "address",
                         preds=(Pred("address", "addr_id"),),
                         joins=(Join("addr_co_id", "country"),), limit=1)


def _fold_stream(eng, server, fold):
    """A reseed and a steady beat, the batch registered before the third
    beat (foreground build: the migration beat), then steady beats; the
    tickets of each beat."""
    beats = []
    steady = [("get_book", (5, 5)), ("get_customer", (8, 8)),
              ("get_cart", (12, 12)), ("order_display", (9, 9)),
              ("order_lines", (26, 26))]
    for beat in range(6):
        if beat == 2 and fold is not None:
            out = server.register_templates(
                [(fold[0][n], fold[1][n]) for n in FOLD_BATCH])
            assert [r["status"] for r in out] == ["folding"] * 3
        qs = steady if beat >= 2 else steady[:2]
        if beat:
            server.submit_update("customer", "update", {
                "key": 3 + beat, "col": "c_expiration", "val": 900 + beat})
            server.submit_update("shopping_cart_line", "update", {
                "key": 2 * beat, "col": "scl_qty", "val": 1 + beat % 3})
        tickets = [server.submit(n, {0: p}) for n, p in qs]
        server.heartbeat()
        beats.append(((eng.last_scan_path, eng.last_join_path),
                      [(t.template, t.result) for t in tickets]))
    return beats


def test_fold_under_mesh_equals_cold_engine():
    """Fold the reference's three-template batch into a 2-shard engine
    while it serves: from the migration beat on, tickets equal a cold
    2-shard engine built with the final set, snapshots too."""
    by_name, caps, base = _split()
    _, _, final = _split(final=True)
    eng = SharedDBEngine(base, tpcw.DEFAULT_UPDATE_SLOTS, _data(),
                         kernels="torch", mesh=mesh(2))
    got = _fold_stream(eng, QueryCycleServer(eng, background_folds=False),
                       (by_name, caps))
    assert eng.folds_done == 1
    cold = SharedDBEngine(final, tpcw.DEFAULT_UPDATE_SLOTS, _data(),
                          kernels="torch", mesh=mesh(2))
    want = _fold_stream(cold, QueryCycleServer(cold), None)
    assert got[2][0] == ("full", "full")        # the migration beat
    assert got[4][0] == got[5][0] == ("delta", "delta")
    for beat in range(2, 6):
        assert got[beat][0] == want[beat][0] or beat == 2, beat
        for (name, g), (_, w) in zip(got[beat][1], want[beat][1]):
            for k in w:
                if k == "scores":
                    np.testing.assert_allclose(g[k], w[k], rtol=1e-6)
                else:
                    np.testing.assert_array_equal(g[k], w[k],
                                                  err_msg=(beat, name, k))
    for table in final.catalog.schemas:
        a, b = eng.snapshot(table), cold.snapshot(table)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=(table, k))


def test_fold_adding_a_mirrored_table_is_refused():
    """``buy_request_address`` joins address to country, which no join
    probed before: under a mesh the fold is refused with the reference's
    ``fold-mirror-set`` finding; unsharded it folds."""
    _, _, base = _split(final=True)
    tmpl = buy_request_address()
    eng = SharedDBEngine(base, tpcw.DEFAULT_UPDATE_SLOTS, _data(),
                         kernels="torch", mesh=mesh(2))
    with pytest.raises(ValueError, match=r"\[planlint:fold-mirror-set\]"):
        eng.begin_fold([tmpl], {tmpl.name: 16}, background=False)
    assert not eng.fold_in_flight()
    # the same finding as the reference's pass on the same plans
    from repro_torch.core import folding
    new = folding.extend_plan(base, [tmpl], {tmpl.name: 16})
    rcat = ref_tpcw.make_catalog(SCALE_I, SCALE_C, dense_pk_index=False)
    rt, rcaps = ref_tpcw.make_templates(rcat.schemas["item"].capacity)
    rbase = ref_compile(rcat, rt, rcaps)
    rtmpl = RTemplate("buy_request_address", "address",
                      preds=(RPred("address", "addr_id"),),
                      joins=(RJoin("addr_co_id", "country"),), limit=1)
    rnew = ref_compile(rcat, rt + [rtmpl], dict(rcaps, buy_request_address=16))
    got = [f.format() for f in tpasses.lint_fold_mirrors(base, new)]
    want = [f.format() for f in rpasses.lint_fold_mirrors(rbase, rnew)]
    assert got == want and len(got) == 1
    assert tpasses.lint_fold_mirrors(base, base) == []
    unsharded = SharedDBEngine(base, tpcw.DEFAULT_UPDATE_SLOTS, _data(),
                               kernels="torch", device="cpu")
    unsharded.begin_fold([tmpl], {tmpl.name: 16}, background=False)
    assert unsharded.fold_ready()


# ------------------------------------------------- entry points and lint
def test_lint_shards_exits_zero_on_the_cpu(capsys):
    from repro_torch.analysis_static import lint
    assert lint.main(["--device", "cpu", "--shards", "2",
                      "--workloads", "tpcw-nopk"]) == 0
    assert "[  ok] tpcw-nopk/torch/shards=2" in capsys.readouterr().out


def test_make_row_mesh_without_devices_raises_past_the_cards():
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match=f"need {have + 1} CUDA devices"):
        sharding.make_row_mesh(have + 1)
    with pytest.raises(ValueError):
        sharding.make_row_mesh(0, [])
    m = sharding.make_row_mesh(3, ["cpu"] * 3)
    assert m.n_shards == 3 and m.one_device
    assert m.devices == (torch.device("cpu"),) * 3


def test_mesh_engine_refuses_what_it_cannot_run():
    """Nothing falls back to one shard: a device that is not the mesh's
    first, or a mesh mixing device types, raises."""
    plan = tpcw.build_tpcw_plan(SCALE_I, SCALE_C, dense_pk_index=False)
    odd = sharding.RowMesh((torch.device("cpu"), torch.device("meta")))
    with pytest.raises(ValueError, match="mixes device types"):
        SharedDBEngine(plan, tpcw.DEFAULT_UPDATE_SLOTS, _data(),
                       kernels="torch", mesh=odd, jit=False)
    with pytest.raises(ValueError, match="not the mesh's first device"):
        SharedDBEngine(plan, tpcw.DEFAULT_UPDATE_SLOTS, _data(),
                       kernels="torch", mesh=mesh(2), device="meta")
