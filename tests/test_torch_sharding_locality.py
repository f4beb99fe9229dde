"""Collective locality of the port's sharded heartbeat, proved on the ops
a beat runs (the port's counterpart of tests/test_sharding_locality.py,
whose proofs read jaxprs and compiled HLO).

``trace_passes.record_beats`` records one body of each cycle flavour of
a 4-shard engine (``["cpu"] * 4``, index-less TPC-W at 64/128, every join
on a carried access path): every op with its shard scope and storages,
and every collective with its operands.

  * both delta flavours record no collective and no read across shards
    (``jaxpr-delta-collective``), and a body that reads another shard's
    temporary, or gathers in a delta beat, is caught;
  * the reseed records exactly one ``all_gather_rows`` per mirrored
    predicated stage over ``[Ts, w]`` operands on each shard
    (``jaxpr-reseed-collective``);
  * through the real engine, the reseed's compare kernel runs at
    per-shard row counts only (each shard rescans its own rows once) and
    the steady delta beat never at the full window of the item stage;
  * the fixed buffers of a mesh generation are disjoint shard by shard.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.analysis_static import trace_passes as tp
from repro_torch.analysis_static.diagnostics import errors_in
from repro_torch.core import backends as tb
from repro_torch.core import sharding
from repro_torch.core.executor import SharedDBEngine
from repro_torch.core.lowering import lower_plan
from repro_torch.workloads import tpcw

SCALE_I, SCALE_C = 64, 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Ops at scale 64/128 gain nothing from intra-op threads; one thread
    keeps this module from oversubscribing the cores that parallel test
    workers share (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine(shards=4, kernels="torch", dense=False):
    plan = tpcw.build_tpcw_plan(SCALE_I, SCALE_C, dense_pk_index=dense)
    data = tpcw.generate_data(np.random.default_rng(0), SCALE_I, SCALE_C)
    return SharedDBEngine(plan, tpcw.DEFAULT_UPDATE_SLOTS, data,
                          kernels=kernels,
                          mesh=sharding.make_row_mesh(shards,
                                                      ["cpu"] * shards))


@pytest.fixture(scope="module")
def recorded():
    eng = _engine()
    # a seeded carry and a steady admission, so the delta bodies merge
    # live panes and dirty rows
    eng.submit_update("customer", "update",
                      {"key": 3, "col": "c_expiration", "val": 14000})
    eng.submit("get_customer", {0: (5, 5)})
    eng.submit("order_lines", {0: (7, 7)})
    eng.run_until_drained()
    return eng, tp.record_beats(eng)


def test_delta_beat_executes_no_cross_shard_collective(recorded):
    """Both delta flavours are shard-local: no collective op, and every
    shard's ops touch only its own storages; the proof is not vacuous
    (all four shards ran ops on storages they own)."""
    eng, recs = recorded
    for f in ("delta", "delta_join"):
        rec = recs[f]
        assert rec.collectives == []
        assert errors_in(tp.lint_delta_collectives(rec)) == []
        assert {shard for _, shard, _ in rec.shard_ops} == {0, 1, 2, 3}
        assert set(rec.owners.values()) == {0, 1, 2, 3}
    # a gather, or one shard's op reading another shard's storage, fails
    rec = recs["delta_join"]
    shard0 = next(k for k, i in rec.owners.items() if i == 0)
    bad = dataclasses.replace(
        rec, collectives=[("all_gather_rows", ((8, 1),) * 4)],
        shard_ops=rec.shard_ops + [("index", 2, {shard0})])
    msgs = [f.message for f in errors_in(tp.lint_delta_collectives(bad))]
    assert any("all_gather_rows" in m for m in msgs)
    assert any("shard 2's index touches shard 0's storage" in m
               for m in msgs)


def test_a_read_across_shards_in_a_real_body_is_caught(monkeypatch):
    """Mutation: a backend whose group-by reads the previous shard's
    group codes (one extra op on shard 1's side) — the recorded delta
    body fails the locality pass."""
    base = tb.get_backend("torch")
    last = {}

    def leaky(codes, vals, mask, n_groups):
        prev = last.get("codes")
        last["codes"] = codes
        if prev is not None and prev.shape == codes.shape:
            codes = codes + 0 * prev
        return base.groupby(codes, vals, mask, n_groups)
    leaky_backend = dataclasses.replace(base, groupby=leaky)
    monkeypatch.setattr(tb, "get_backend", lambda name: leaky_backend)
    eng = _engine(shards=2)
    eng.submit("best_sellers", {0: (0, tpcw.INT_MAX), 1: (4, 4)})
    eng.run_until_drained()
    rec = tp.record_beats(eng)["delta"]
    msgs = [f.message for f in errors_in(tp.lint_delta_collectives(rec))]
    assert any("shard 1's" in m and "shard 0's storage" in m for m in msgs)


def test_reseed_beat_allgathers_each_mirrored_stage_exactly_once(recorded):
    """The reseed's only collective is one all_gather per mirrored
    predicated stage, each over that stage's [Ts, w] slices on all four
    shards; no other read across shards."""
    eng, recs = recorded
    spec, lowered = eng._gen.spec, eng._gen.lowered
    mi_pred = [st for st in lowered.scans
               if spec.is_mirrored(st.table) and st.cols]
    assert mi_pred, "plan has no mirrored predicated stage to prove"
    rec = recs["full"]
    assert errors_in(tp.lint_reseed_collectives(rec, lowered, spec)) == []
    assert len(rec.collectives) == len(mi_pred)
    for name, shapes in rec.collectives:
        assert name == "all_gather_rows" and len(shapes) == 4
    # one gather too many, or the full table gathered, fails
    extra = dataclasses.replace(rec, collectives=rec.collectives * 2)
    assert errors_in(tp.lint_reseed_collectives(extra, lowered, spec))
    st = mi_pred[0]
    whole = [("all_gather_rows",
              ((spec.padded[st.table], st.whi - st.wlo),) * 4)] + \
        rec.collectives[1:]
    assert errors_in(tp.lint_reseed_collectives(
        dataclasses.replace(rec, collectives=whole), lowered, spec))


def test_reseed_rescans_per_shard_and_delta_skips_full_compare():
    """Engine-level recording, 4 shards, the chained ops (no fused op):
    the seeding full beat's compare kernels all run at PER-SHARD row
    counts, the item stage's full-width compare at its shard rows; the
    steady delta beats compare panes only, never the full window."""
    record = []
    base = tb.get_backend("torch")

    def scan(cols, lo, hi, valid):
        record.append((int(cols.shape[1]), int(lo.shape[1])))
        return base.scan(cols, lo, hi, valid)
    tb.register_backend(dataclasses.replace(
        base, name="recording-sharded-test", scan=scan, fused_delta=None))
    eng = _engine(kernels="recording-sharded-test", dense=True)
    spec = eng._gen.spec
    lowered = lower_plan(eng.plan)
    item = next(s for s in lowered.scans if s.table == "item")
    full_width, pane_width = item.q_window, 32 * item.delta_words
    assert pane_width < full_width
    eng.submit("admin_item", {0: (1, 1)})
    eng.run_until_drained()
    assert eng.last_scan_path == "full"
    assert {r for r, _ in record} == {spec.shard_rows[st.table]
                                      for st in lowered.scans if st.cols}
    assert (spec.shard_rows["item"], full_width) in record
    record.clear()
    for i in range(3):
        eng.submit_update("customer", "update",
                          {"key": 2 + i, "col": "c_expiration",
                           "val": 14000 + i})
        eng.submit("admin_item", {0: (1, 1)})
        eng.run_until_drained()
        assert eng.last_scan_path == "delta"
    assert record and all(q < full_width for _, q in record), record
    assert (spec.padded["item"], pane_width) in record


def test_mesh_generation_buffers_are_disjoint_shard_by_shard(recorded):
    """The fixed buffers of a mesh generation, one group per shard, are
    disjoint; two shards sharing one storage is caught."""
    eng, _ = recorded
    assert errors_in(tp.lint_buffer_aliasing(eng._gen, eng.state)) == []
    shared = list(eng.state)
    shared[1] = dict(shared[1], customer=shared[0]["customer"])
    msgs = [f.message for f in errors_in(
        tp.lint_buffer_aliasing(eng._gen, tuple(shared)))]
    assert any("state shard 0" in m and "state shard 1" in m for m in msgs)


def test_width_sets_take_the_shard_geometry():
    """Under a mesh the forbidden and legitimate compare shapes include
    the padded and per-shard row counts (the reference's
    ``_row_candidates``)."""
    eng = _engine(shards=4, dense=False)
    spec, lowered = eng._gen.spec, eng._gen.lowered
    forbidden, legit = tp._width_shape_sets(lowered, spec)
    item = next(s for s in lowered.scans if s.table == "item")
    for rows in (spec.shard_rows["item"], spec.padded["item"]):
        assert (rows, item.q_window) in forbidden
        assert (rows, 32 * item.delta_words) in legit
    pf, _ = tp._probe_shape_sets(lowered, tpcw.DEFAULT_UPDATE_SLOTS, spec)
    j = next(j for j in lowered.joins if j.kind == "partitioned"
             and not spec.is_mirrored(j.spine))
    assert (spec.shard_rows[j.spine], j.bucket_cap) in pf
