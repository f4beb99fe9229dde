"""Port parity, engine: the deterministic differential streams of
tests/test_differential_engine.py replayed into the PyTorch engine
(``device="cpu"``, ``kernels="torch"``) and the JAX engine
(``kernels="jnp"``): tickets equal ticket for ticket,
snapshots and carries equal every beat, and the scan / join path
sequences equal — through the fused delta op and through the chained
fallback."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.executor import SharedDBEngine as RefEngine
from repro.workloads import tpcw as ref_tpcw
from repro_torch.core import backends as tb
from repro_torch.core import dataquery
from repro_torch.core.baseline import QueryAtATimeEngine
from repro_torch.core.executor import SharedDBEngine
from repro_torch.core.lowering import (build_cycle, build_delta_cycle,
                                       lower_plan)
from repro_torch.core.storage import (bulk_load, empty_update_batch,
                                      state_from_numpy, tree_to_torch)
from repro_torch.workloads import tpcw

SCALE_I, SCALE_C = 64, 128
INT_MAX = tpcw.INT_MAX


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Ops at these sizes gain nothing from intra-op threads; one thread
    keeps this module from oversubscribing the cores that parallel test
    workers share (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _words(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.int32 else a


class _World:
    """Port engines and one reference engine on the same plan and data,
    driven with the same operations and compared every beat.

    The reference runs jitted (its cycles compile once per flavour;
    eager JAX compiles every op at first use, minutes for these
    streams).  ``chained`` adds a port engine on a backend without
    ``fused_delta``: the chained delta ops, held to the same reference."""

    def __init__(self, dense_pk_index, chained=False):
        data = tpcw.generate_data(np.random.default_rng(0), SCALE_I, SCALE_C)
        self.plan = tpcw.build_tpcw_plan(SCALE_I, SCALE_C,
                                         dense_pk_index=dense_pk_index)
        self.ref = RefEngine(
            ref_tpcw.build_tpcw_plan(SCALE_I, SCALE_C,
                                     dense_pk_index=dense_pk_index),
            ref_tpcw.DEFAULT_UPDATE_SLOTS, data, jit=True, kernels="jnp")
        kinds = ["torch"]
        if chained:
            tb.register_backend(dataclasses.replace(
                tb.get_backend("torch"), name="torch-chained-test",
                fused_delta=None))
            kinds.append("torch-chained-test")
        self.ports = {k: SharedDBEngine(self.plan, tpcw.DEFAULT_UPDATE_SLOTS,
                                        data, kernels=k, device="cpu")
                      for k in kinds}
        self.pending = []
        self.paths = []
        self.next_item, self.next_cust = SCALE_I, SCALE_C
        self.item_watermark = SCALE_I

    def update(self, u):
        self.ref.submit_update(*u)
        for eng in self.ports.values():
            eng.submit_update(*u)

    def insert_item(self, subject, cost):
        i = self.next_item
        self.next_item += 1
        self.update(("item", "insert", {
            "i_id": i, "i_a_id": i % max(SCALE_I // 4, 1),
            "i_subject": subject, "i_title": i % tpcw.N_TITLE_TOKENS,
            "i_pub_date": 11500, "i_cost": cost, "i_srp": cost + 100,
            "i_stock": 5, "i_related1": 0}))

    def insert_customer(self):
        c = self.next_cust
        self.next_cust += 1
        self.update(("customer", "insert", {
            "c_id": c, "c_uname": c, "c_passwd": c * 7,
            "c_addr_id": c % SCALE_C, "c_discount": c % 50,
            "c_since": 11000, "c_expiration": 13000}))

    def submit(self, name, params):
        self.pending.append((self.ref.submit(name, params),
                             {k: e.submit(name, params)
                              for k, e in self.ports.items()}))

    def heartbeat(self):
        self.ref.run_until_drained()
        for eng in self.ports.values():
            eng.run_until_drained()
        for tr, tps in self.pending:
            for kind, tp in tps.items():
                for k, want in tr.result.items():
                    got, want = np.asarray(tp.result[k]), np.asarray(want)
                    if k == "scores":
                        np.testing.assert_allclose(
                            got, want, rtol=1e-6, err_msg=(kind, tp.template))
                    else:
                        np.testing.assert_array_equal(
                            got, want, err_msg=(kind, tp.template, k))
        self.pending = []
        self.item_watermark = self.next_item
        self.paths.append((self.ref.last_scan_path, self.ref.last_join_path))
        for kind, eng in self.ports.items():
            self._compare(kind, eng)

    def _compare(self, kind, eng):
        ref = self.ref
        assert (eng.last_scan_path, eng.last_join_path) == self.paths[-1]
        assert eng.last_overflow == ref.last_overflow
        assert eng.last_parts_rebuilt == ref.last_parts_rebuilt
        for table in self.plan.catalog.schemas:
            got, want = eng.state[table], ref.state[table]
            assert sorted(got) == sorted(want), table
            for k in want:
                np.testing.assert_array_equal(
                    np.asarray(got[k]), np.asarray(want[k]),
                    err_msg=f"{kind} snapshot {table}.{k}")
        # the carry: scan words, key partitions and join rids
        cp, cr = eng._carry, ref._carry
        assert sorted(cp["scan"]) == sorted(cr["scan"])
        for t in cr["scan"]:
            np.testing.assert_array_equal(_words(cp["scan"][t]),
                                          np.asarray(cr["scan"][t]))
        for t in cr["parts"]:
            for a, b in zip(cp["parts"][t], cr["parts"][t]):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        for key, rid in ref._rid_carry.items():
            np.testing.assert_array_equal(np.asarray(eng._rid_carry[key]),
                                          np.asarray(rid), err_msg=key)


def test_deterministic_interleaved_stream_equal():
    """The interleaved insert / update / delete / select stream of
    test_differential_engine (seed 42), dense-index catalog."""
    rng = np.random.default_rng(42)
    w = _World(dense_pk_index=True)
    for beat in range(4):
        for _ in range(int(rng.integers(2, 6))):
            op = rng.integers(0, 6)
            if op == 0:
                w.update(("item", "update", {
                    "key": int(rng.integers(0, SCALE_I)),
                    "col": "i_cost", "val": int(rng.integers(0, 9999))}))
            elif op == 1 and w.item_watermark > 0:
                w.update(("item", "delete", {
                    "key": int(rng.integers(0, w.item_watermark))}))
            elif op == 2:
                w.insert_item(int(rng.integers(0, tpcw.N_SUBJECTS)),
                              int(rng.integers(100, 9999)))
            elif op == 3:
                w.insert_customer()
            elif op == 4:
                w.update(("customer", "update", {
                    "key": int(rng.integers(0, SCALE_C)),
                    "col": "c_expiration",
                    "val": int(rng.integers(12000, 15000))}))
            else:
                w.update(("item", "update", {
                    "key": int(rng.integers(0, SCALE_I)),
                    "col": "i_subject",
                    "val": int(rng.integers(0, tpcw.N_SUBJECTS))}))
        w.submit("admin_item", {0: (int(rng.integers(0, SCALE_I)),) * 2})
        w.submit("get_customer", {0: (int(rng.integers(0, SCALE_C)),) * 2})
        w.submit("search_subject",
                 {0: (int(rng.integers(0, tpcw.N_SUBJECTS)),) * 2})
        if beat % 2:
            s = int(rng.integers(0, tpcw.N_SUBJECTS))
            w.submit("best_sellers", {0: (0, INT_MAX), 1: (s, s)})
        w.heartbeat()
    for _ in range(3):
        k = int(rng.integers(0, SCALE_I))
        w.update(("item", "update", {"key": k, "col": "i_cost",
                                     "val": int(rng.integers(0, 999))}))
        w.submit("admin_item", {0: (k, k)})
        w.heartbeat()
    # one synchronous beat through run_cycle, then the host-side fetches
    w.submit("admin_item", {0: (3, 3)})
    w.ref.run_cycle()
    for eng in w.ports.values():
        eng.run_cycle()
    w.heartbeat()
    eng = w.ports["torch"]
    for table in ("item", "customer"):
        got, want = eng.snapshot(table), w.ref.snapshot(table)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=table)
    rows = np.array([-1, 0, 3, SCALE_I - 1, SCALE_I + 2], np.int32)
    got, want = eng.materialize("item", rows), w.ref.materialize("item", rows)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert w.ref.delta_cycles > 0
    assert w.ports["torch"].delta_cycles == w.ref.delta_cycles


def test_deterministic_indexless_delta_join_stream_equal():
    """The index-less stream of test_differential_engine (seed 7):
    PK-side-write beats, carried-rid beats, a dirty-overflow reseed and
    the recovery beat — through the fused op and the chained ops."""
    rng = np.random.default_rng(7)
    w = _World(dense_pk_index=False, chained=True)

    def submit_joins(o_id):
        w.submit("order_lines", {0: (o_id, o_id)})
        w.submit("get_cart", {0: (12, 12)})
        w.submit("get_book", {0: (5, 5)})

    for beat in range(3):
        if beat:
            w.update(("item", "update", {
                "key": int(rng.integers(0, SCALE_I)), "col": "i_cost",
                "val": int(rng.integers(100, 9999))}))
        submit_joins(10 + beat)
        w.heartbeat()
    for beat in range(4):
        w.update(("customer", "update", {
            "key": int(rng.integers(0, SCALE_C)), "col": "c_expiration",
            "val": int(rng.integers(12000, 15000))}))
        submit_joins(20 + beat)
        w.heartbeat()
    dirty_cap = w.plan.catalog.schemas["item"].dirty_cap
    n_upd = min(tpcw.DEFAULT_UPDATE_SLOTS.n_update, dirty_cap)
    for k in range(n_upd):
        w.update(("item", "update", {"key": k, "col": "i_stock", "val": 1}))
    for k in range(n_upd, dirty_cap + 1):
        w.update(("item", "delete", {"key": k}))
    submit_joins(30)
    w.heartbeat()
    w.update(("customer", "update", {"key": 1, "col": "c_expiration",
                                     "val": 14999}))
    submit_joins(31)
    w.heartbeat()
    assert [j for _, j in w.paths] == ["full"] * 3 + ["delta"] * 4 \
        + ["full", "delta"]
    assert w.paths[7] == ("full", "full")
    fused = w.ports["torch"].last_collect_stats["backend_ops"]
    chained = w.ports["torch-chained-test"].last_collect_stats["backend_ops"]
    assert fused == {"fused_delta": 1, "groupby": 1}, fused
    assert chained.get("fused_delta", 0) == 0 and chained["join_delta"] >= 1
    _delta_cycle_from_reference_snapshot(w)


def _delta_cycle_from_reference_snapshot(w):
    """The reference engine's mid-stream state and carries, carried into
    the port with ``state_from_numpy``: one delta-join beat of the port's
    ``build_delta_cycle`` answers like the reference's compiled cycle on
    the same admission and updates, and leaves equal state and carries."""
    plan, ref = w.plan, w.ref
    params = np.zeros((plan.qcap, plan.n_params_max, 2), np.int32)
    active = np.zeros((plan.qcap,), bool)
    for name, v in (("order_lines", 33), ("get_cart", 12), ("get_book", 5)):
        active[plan.offsets[name]] = True
        params[plan.offsets[name], 0] = (v, v)
    changed = np.zeros((plan.qcap,), bool)
    changed[plan.offsets["order_lines"]] = True
    queries = {"params": params, "active": active, "changed": changed}
    updates = {t: empty_update_batch(s, tpcw.DEFAULT_UPDATE_SLOTS, xp=np)
               for t, s in plan.catalog.schemas.items()}
    updates["customer"]["upd_key"][0] = 2
    updates["customer"]["upd_col"][0] = 6            # c_expiration
    updates["customer"]["upd_val"][0] = 14000
    updates["customer"]["upd_mask"][0] = True

    host = jax.tree.map(np.asarray, (ref.state, ref._carry, ref._rid_carry))
    want = ref._cycle_delta_join(*jax.tree.map(jnp.array, host),
                                 jax.tree.map(jnp.asarray, queries),
                                 jax.tree.map(jnp.asarray, updates))
    cycle = build_delta_cycle(w.ports["torch"]._lowered,
                              tb.get_backend("torch"), delta_joins=True,
                              device="cpu")
    got = cycle(state_from_numpy(plan.catalog, host[0], "cpu"),
                *(tree_to_torch(x, "cpu")
                  for x in (host[1], host[2], queries, updates)))
    flat_w = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, want))
    flat_g = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), got,
                     is_leaf=lambda x: hasattr(x, "numpy")))
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, v) in zip(flat_g, flat_w):
        if v.dtype == np.float32:
            np.testing.assert_allclose(g, v, rtol=1e-6, err_msg=str(path))
        else:
            np.testing.assert_array_equal(_words(g), _words(v),
                                          err_msg=str(path))


def test_hopper_backend_on_cpu_and_port_baseline_agree():
    """The hopper wrappers compute their plain versions for CPU tensors:
    an index-less engine on them answers like the port's own
    query-at-a-time oracle, across a reseed and a steady delta beat."""
    data = tpcw.generate_data(np.random.default_rng(1), SCALE_I, SCALE_C)
    plan = tpcw.build_tpcw_plan(SCALE_I, SCALE_C, dense_pk_index=False)
    eng = SharedDBEngine(plan, tpcw.DEFAULT_UPDATE_SLOTS, data,
                         kernels="hopper", device="cpu")
    base = QueryAtATimeEngine(plan, data, device="cpu")
    subs = [("order_lines", {0: (10, 10)}), ("get_cart", {0: (12, 12)}),
            ("get_book", {0: (5, 5)}), ("search_author", {0: (100, 120)}),
            ("best_sellers", {0: (0, INT_MAX), 1: (2, 2)})]
    for beat in range(2):
        u = ("customer", "update", {"key": 3, "col": "c_expiration",
                                    "val": 13000 + beat})
        eng.submit_update(*u)
        base.apply_update(*u)
        tickets = [eng.submit(n, p) for n, p in subs]
        done = eng.run_until_drained(pipelined=True)
        for t in tickets:
            want = base.execute(t.template, t.params).result
            if "rows" in want:
                assert set(t.result["rows"][t.result["rows"] >= 0]) == \
                    set(want["rows"][want["rows"] >= 0]), t.template
            else:
                np.testing.assert_allclose(np.sort(t.result["scores"]),
                                           np.sort(want["scores"]),
                                           rtol=1e-6)
    assert (eng.last_scan_path, eng.last_join_path) == ("delta", "delta")
    assert done[-1].backend_ops == {"fused_delta": 1, "groupby": 1}


ENTRY_POINTS = {
    "resolve_backend": lambda w, **d: tb.resolve_backend("auto", **d),
    "init_state": lambda w, **d: w["plan"].catalog.init_state(w["data"],
                                                              **d),
    "bulk_load": lambda w, **d: bulk_load(
        w["plan"].catalog.schemas["item"], w["data"]["item"], **d),
    "state_from_numpy": lambda w, **d: state_from_numpy(
        w["plan"].catalog, w["state"], **d),
    "tree_to_torch": lambda w, **d: tree_to_torch(w["data"], **d),
    "build_cycle": lambda w, **d: build_cycle(
        w["lowered"], tb.get_backend("torch"), **d),
    "build_delta_cycle": lambda w, **d: build_delta_cycle(
        w["lowered"], tb.get_backend("torch"), delta_joins=True, **d),
    "SharedDBEngine": lambda w, **d: SharedDBEngine(
        w["plan"], tpcw.DEFAULT_UPDATE_SLOTS, w["data"], **d),
    "QueryAtATimeEngine": lambda w, **d: QueryAtATimeEngine(
        w["plan"], w["data"], **d),
    "empty_mask": lambda w, **d: dataquery.empty_mask(4, 64, **d),
    "full_mask": lambda w, **d: dataquery.full_mask(4, 64, **d),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_points_run_on_the_card_unless_the_cpu_is_asked_for(
        entry, monkeypatch):
    """With no device given, every entry point means the CUDA card and
    raises when there is none; ``device="cpu"`` runs the plain path."""
    data = tpcw.generate_data(np.random.default_rng(3), SCALE_I, SCALE_C)
    plan = tpcw.build_tpcw_plan(SCALE_I, SCALE_C, dense_pk_index=False)
    w = {"data": data, "plan": plan, "lowered": lower_plan(plan),
         "state": plan.catalog.init_state(data, "cpu")}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[entry](w)
    got = ENTRY_POINTS[entry](w, device="cpu")
    if entry == "resolve_backend":
        assert got.name == "torch"
