"""The compiled beat's precondition, on the CPU: one body on fixed
buffers.

A CUDA graph replays the addresses its capture saw, so the port's beat
body (``SharedDBEngine._body``, captured per cycle flavour and pipeline
slot on a card) must read and write the same tensors every beat.  Here,
without a card, the same body runs eagerly (``graphed`` is False), and
these tests hold it to that precondition and to the JAX reference:

  * addresses: over full -> delta -> delta_join -> fold migration ->
    delta beats on the dense, index-less and chained engines, every
    tensor that crosses a beat boundary keeps its ``data_ptr`` — state
    (across the fold too), scan carry, key partitions, each slot's
    staged inputs, rid and result buffers (within a plan generation);
  * parity: the static-buffer engine's tickets and paths equal the
    reference's, beat for beat with one or two beats in flight
    (``pipeline_depth`` 1 and 2) and through a pipelined drain;
  * no aliasing: beat N's results stay as they were after beat N+1 is
    dispatched and before N is collected;
  * LM: ``CycleServer``'s token, position and logits buffers keep their
    addresses, and its tokens equal the reference's.

Tolerance: tickets bit-equal (group scores rtol 1e-6, as
``test_torch_engine.py`` compares them); LM tokens equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.core.executor import SharedDBEngine as RefEngine
from repro.serving import CycleServer as RefCycleServer
from repro.workloads import tpcw as ref_tpcw
from repro_torch import configs
from repro_torch.core import backends as tb
from repro_torch.core import graphs as cg
from repro_torch.core.executor import SharedDBEngine
from repro_torch.core.plan import Join, Pred, QueryTemplate
from repro_torch.models import transformer
from repro_torch.models.registry import params_from_numpy
from repro_torch.serving import CycleServer
from repro_torch.workloads import tpcw

SCALE_I, SCALE_C = 128, 256
CHAINED = "torch-chained-graph-test"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Ops at these sizes gain nothing from intra-op threads; one thread
    keeps this module from oversubscribing the cores that parallel test
    workers share (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data():
    return tpcw.generate_data(np.random.default_rng(0), SCALE_I, SCALE_C)


def _engine(kind, **kw):
    """``dense`` / ``indexless`` on ``torch``; ``chained``: index-less on
    ``torch`` without fused_delta (the chained delta ops)."""
    tb.register_backend(dataclasses.replace(
        tb.get_backend("torch"), name=CHAINED, fused_delta=None))
    plan = tpcw.build_tpcw_plan(SCALE_I, SCALE_C,
                                dense_pk_index=kind == "dense")
    return SharedDBEngine(plan, tpcw.DEFAULT_UPDATE_SLOTS, _data(),
                          kernels=CHAINED if kind == "chained" else "torch",
                          device="cpu", **kw)


def _buy_request_address():
    return QueryTemplate("buy_request_address", "address",
                         preds=(Pred("address", "addr_id"),),
                         joins=(Join("addr_co_id", "country"),), limit=1)


def _customer_update(beat):
    return ("customer", "update", {"key": 3 + beat, "col": "c_expiration",
                                   "val": 900 + beat})


# beat -> (updates, fold before the beat): a reseed; an item update (the
# PK side of carried joins: delta scans, full join probes); a customer
# update (delta scans and joins); the fold's migration beat; a steady beat
STREAM = (([], False),
          ([("item", "update", {"key": 7, "col": "i_cost", "val": 1234})],
           False),
          ([_customer_update(2)], False),
          ([_customer_update(3)], True),
          ([_customer_update(4)], False))
QUERIES = (("get_book", (5, 5)), ("get_cart", (12, 12)),
           ("order_lines", (26, 26)), ("get_customer", (8, 8)))
ADDRESSES = (5, 7, 9, 11)
PATHS = {"dense": [("full", ""), ("delta", ""), ("delta", ""), ("full", ""),
                   ("delta", "")],
         "indexless": [("full", "full"), ("delta", "full"),
                       ("delta", "delta"), ("full", "full"),
                       ("delta", "delta")]}
PATHS["chained"] = PATHS["indexless"]


def _generation_ptrs(eng):
    """data_ptr of every buffer the installed generation owns: the scan
    carry (words and key partitions), each slot's staged admission and
    its results (whose ``_join_rids`` are the slot's rid carry)."""
    h = eng._gen
    return {"carry": [t.data_ptr() for t in cg.leaves(h.carry)],
            "staged": [[t.data_ptr() for t in cg.leaves(b.staged)]
                       for b in h.staging],
            "results": [[t.data_ptr() for t in cg.leaves(r)]
                        for r in h.results]}


def _state_ptrs(eng):
    return [t.data_ptr() for t in cg.leaves(eng.state)]


@pytest.mark.parametrize("kind", ["dense", "indexless", "chained"])
def test_boundary_tensors_keep_their_addresses(kind):
    eng = _engine(kind)
    assert not eng.graphed          # the CPU: the body runs eagerly
    state = _state_ptrs(eng)
    gen = _generation_ptrs(eng)
    assert len(gen["results"]) == len(gen["staged"]) == 2
    paths, gens = [], 0
    for beat, (ups, fold) in enumerate(STREAM):
        if fold:
            eng.begin_fold([_buy_request_address()],
                           {"buy_request_address": 16}, background=False)
        for u in ups:
            eng.submit_update(*u)
        tickets = [eng.submit(n, {0: p}) for n, p in QUERIES]
        if fold or eng.folds_done:
            tickets += [eng.submit("buy_request_address", {0: (a, a)})
                        for a in ADDRESSES]
        eng.run_until_drained()
        assert all(t.result is not None for t in tickets)
        paths.append((eng.last_scan_path, eng.last_join_path))
        if eng.folds_done != gens:      # a new generation, new buffers
            gens = eng.folds_done
            gen = _generation_ptrs(eng)
        assert _state_ptrs(eng) == state, beat
        assert _generation_ptrs(eng) == gen, beat
        # the carries the next beat reads are the generation's buffers
        assert [t.data_ptr() for t in cg.leaves(eng._carry)] == \
            gen["carry"]
        rids = {t.data_ptr() for r in eng._gen.results
                for t in cg.leaves(r["_join_rids"])}
        assert {t.data_ptr() for t in cg.leaves(eng._rid_carry)} <= rids
    assert paths == PATHS[kind]
    assert eng.folds_done == 1
    assert eng.capture_stats == [{"generation": 0}, {"generation": 1}]


def _ref_engine(depth):
    plan = ref_tpcw.build_tpcw_plan(SCALE_I, SCALE_C, dense_pk_index=False)
    return RefEngine(plan, ref_tpcw.DEFAULT_UPDATE_SLOTS, _data(), jit=True,
                     kernels="jnp", pipeline_depth=depth)


def _tickets_equal(got, want, what):
    for g, w in zip(got, want):
        assert g.template == w.template
        for k, v in w.result.items():
            a, b = np.asarray(g.result[k]), np.asarray(v)
            if k == "scores":
                np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=what)
            else:
                np.testing.assert_array_equal(a, b, err_msg=(what, k))


@pytest.mark.parametrize("depth", [1, 2])
def test_pipelined_stream_equals_reference(depth):
    """Beats dispatched back to back with ``depth`` in flight (the
    engine collects the oldest itself at full depth), then a queue of
    three beats' work drained pipelined: tickets and paths equal the
    reference's at the same pipeline depth."""
    port, ref = _engine("indexless", pipeline_depth=depth), \
        _ref_engine(depth)
    got, want, paths = [], [], []
    for beat in range(5):
        for e, out in ((port, got), (ref, want)):
            e.submit_update(*_customer_update(beat))
            out += [e.submit(n, {0: p}) for n, p in QUERIES]
            out.append(e.submit("order_display", {0: (beat, beat)}))
            e.dispatch()
        paths.append([(e.last_scan_path, e.last_join_path)
                      for e in (port, ref)])
    for e in (port, ref):
        while e.in_flight():
            e.collect()
    assert all(p == r for p, r in paths), paths
    assert paths[-1][0] == ("delta", "delta")
    _tickets_equal(got, want, f"depth {depth}, beat by beat")
    # 20 order_display queries over its 8 slots: three pipelined beats
    got, want = [], []
    for e, out in ((port, got), (ref, want)):
        for i in range(20):
            out.append(e.submit("order_display", {0: (i, i + 3)}))
        out += [e.submit(n, {0: p}) for n, p in QUERIES]
        done = e.run_until_drained(pipelined=True)
        assert len(done) == 3
    assert all(t.result is not None for t in got)
    _tickets_equal(got, want, f"depth {depth}, pipelined drain")


def _snapshot(tree):
    return {k: _snapshot(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def _trees_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(cg.leaves(a), cg.leaves(b)))


@pytest.mark.parametrize("kind", ["indexless", "chained"])
def test_in_flight_results_survive_the_next_dispatch(kind):
    """Beat N's results (and rids) are unchanged after beat N+1 is
    dispatched and before N is collected, and N's tickets are routed from
    them; the two beats write different slots' buffers."""
    eng = _engine(kind)
    kept, older_tickets = None, []
    for beat in range(4):
        eng.submit_update(*_customer_update(beat))
        tickets = [eng.submit(n, {0: p}) for n, p in QUERIES]
        tickets.append(eng.submit("order_display", {0: (beat, beat + 5)}))
        eng.dispatch()
        newer = eng._inflight[-1]
        if kept is not None:
            older = eng._inflight[0]
            assert {t.data_ptr() for t in cg.leaves(older.results)}.isdisjoint(
                t.data_ptr() for t in cg.leaves(newer.results))
            assert _trees_equal(older.results, kept), beat
            eng.collect()
            for t in older_tickets:         # one ticket a template: slot 0
                for k, v in kept[t.template].items():
                    np.testing.assert_array_equal(t.result[k], v[0].numpy())
            assert (eng.last_scan_path, eng.last_join_path) == \
                ("delta", "delta")        # beat N+1 (customer updates)
        kept, older_tickets = _snapshot(newer.results), tickets
    eng.collect()
    assert all(t.result is not None for t in older_tickets)


def test_jit_flag_on_the_cpu_runs_the_body_eagerly():
    for jit in (True, False):
        eng = _engine("dense", jit=jit)
        assert not eng.graphed and not eng._gen.graphs
        eng.submit("get_book", {0: (5, 5)})
        eng.run_until_drained()
        assert eng.last_collect_stats["backend_ops"]["scan"] > 0


# --------------------------------------------------------------- LM server
def _smoke(arch):
    cfg = dataclasses.replace(configs.smoke_config(arch), n_kv=2)
    ref = dataclasses.replace(ref_configs.smoke_config(arch), n_kv=2)
    return cfg, ref


def test_cycle_server_buffers_keep_their_addresses_and_tokens():
    """yi's smoke config at float32 parameters, the mixed scenario of
    ``test_torch_lm.py`` (a long request and a short one, two slots):
    the decode step's input and logits buffers keep their addresses
    every beat, and the tokens equal the reference's."""
    cfg, ref = _smoke("yi-6b")
    tree = jax.tree.map(lambda t: t.numpy(), transformer.init_lm(
        torch.Generator().manual_seed(0), cfg, torch.device("cpu"),
        torch.float32))
    rp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy(tree, cfg, torch.device("cpu"))
    kw = dict(capacity=2, max_seq=12, prefill_len=4, prefill_budget=2)
    want = RefCycleServer(ref, params=rp, **kw)
    got = CycleServer(cfg, params=tp, device="cpu", **kw)
    assert not got.graphed
    ptrs = [t.data_ptr() for t in (got._tokens, got._positions,
                                   got._logits)]
    reqs = []
    for s in (got, want):
        reqs.append([s.submit([1, 2, 3, 4], 9), s.submit([4, 3, 2], 2)])
    beats = 0
    while got.pending() or got.active():
        got.run_cycle()
        want.run_cycle()
        beats += 1
        assert [t.data_ptr() for t in (got._tokens, got._positions,
                                       got._logits)] == ptrs
        np.testing.assert_array_equal(got._pos, want._pos)
    assert beats > 3 and not want.active()
    for a, b in zip(*reqs):
        assert a.output == b.output and len(a.output) == a.max_new_tokens


# ------------------------------------------------- launch records, copy_into
def test_launch_record_keeps_a_threads_launches_out_of_the_counts():
    """Inside ``kernels.recording()`` a thread's launches count in its
    record (a capture's, replayed by ``add_launches``); another thread's
    launches meanwhile count in ``LAUNCHES`` as before."""
    import threading

    from repro_torch import kernels as K
    before = dict(K.LAUNCHES), dict(K.FLASH_ROUTE_LAUNCHES)
    other = threading.Thread(target=K.count_launch, args=("clockscan",))
    with K.recording() as record:
        K.count_launch("fused_delta")
        K.count_launch("flash_attention", "wgmma")
        K.hold(torch.zeros(3))
        other.start()
        other.join(timeout=10)
    assert not other.is_alive()
    assert record.launches == {"fused_delta": 1, "flash_attention": 1}
    assert record.routes == {"wgmma": 1} and len(record.held) == 1
    got = {k: n - before[0][k] for k, n in K.LAUNCHES.items()}
    assert got == dict.fromkeys(K.LAUNCHES, 0) | {"clockscan": 1}
    K.add_launches(record)
    K.add_launches(record)                      # two replays
    assert K.LAUNCHES["fused_delta"] - before[0]["fused_delta"] == 2
    assert K.FLASH_ROUTE_LAUNCHES["wgmma"] - before[1]["wgmma"] == 2
    K.hold(torch.zeros(1))                      # no record: nothing kept
    assert len(record.held) == 1


def test_copy_into_writes_leaves_in_place_and_refuses_other_shapes():
    dst = {"a": torch.zeros(3, dtype=torch.int32),
           "p": (torch.zeros(2), torch.zeros(2, 2))}
    ptrs = [t.data_ptr() for t in cg.leaves(dst)]
    same = dst["p"][1]
    cg.copy_into(dst, {"a": torch.arange(3, dtype=torch.int32),
                       "p": (torch.ones(2), same)})
    assert [t.data_ptr() for t in cg.leaves(dst)] == ptrs
    assert dst["a"].tolist() == [0, 1, 2] and dst["p"][0].tolist() == [1, 1]
    for bad in ({"a": torch.zeros(4, dtype=torch.int32), "p": dst["p"]},
                {"a": torch.zeros(3), "p": dst["p"]},
                {"a": dst["a"]},
                {"a": dst["a"], "p": (dst["p"][0],)}):
        with pytest.raises(ValueError):
            cg.copy_into(dst, bad)
