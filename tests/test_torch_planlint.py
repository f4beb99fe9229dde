"""Port parity, planlint: ``repro_torch.analysis_static`` held to the JAX
package's ``repro.analysis_static`` on the same plans, at tiny scale on
the CPU (``build_tpcw_plan(64, 128)``, dense and index-less, and the
index-less plan with TPC-W's Buy Request address lookup folded in).

  * the IR and fold passes give the reference's findings (rule,
    location, severity, message) on the same clean and corrupted plans;
    the registry holds the reference's 22 rule ids and families; the key
    stats the partition-geometry rule reads are the reference's;
  * the construction gate: both engines refuse the overlapping-offsets
    plan of ``tests/test_planlint.py`` with ``PlanLintError``
    (``ir-slot-overlap``), at construction and in a fold's build on the
    fold thread, before anything is built for it;
  * the port's own proofs are clean on the shipped plans: the fused_delta
    descriptor ``launch_schedule`` builds (its geometry the one the
    wrapper computes at a real call), the recorded beats, the fixed
    buffers, the hot-path sources;
  * the mutation corpus (``tests/torch_lint_corpus``): each planted bug
    fires its rule;
  * the CLI exits 0 on both workloads and 1 on a corrupted plan, and the
    package imports neither jax nor the JAX package.
"""
import dataclasses
import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis_static import ir_passes as rpasses
from repro.analysis_static import registry as rregistry
from repro.analysis_static.diagnostics import PlanLintError as RPlanLintError
from repro.analysis_static.kernel_passes import \
    geometry_from_lowered as ref_geometry
from repro.core import folding as rfold
from repro.core.executor import SharedDBEngine as RefEngine
from repro.core.executor import _measure_key_stats as ref_key_stats
from repro.core.lowering import lower_plan as ref_lower
from repro.core.plan import Join as RJoin
from repro.core.plan import Pred as RPred
from repro.core.plan import QueryTemplate as RTemplate
from repro.workloads import tpcw as ref_tpcw
from repro_torch.analysis_static import (PlanLintError, errors_in,
                                         ir_passes, kernel_passes, lint,
                                         registry, source_passes,
                                         trace_passes)
from repro_torch.core import backends, folding
from repro_torch.core.executor import SharedDBEngine, _measure_key_stats
from repro_torch.core.lowering import lower_plan
from repro_torch.core.plan import Join, Pred, QueryTemplate
from repro_torch.workloads import tpcw
from torch_lint_corpus import CORPUS

SCALE_I, SCALE_C = 64, 128
FOLD_CAP = 16
PLANS = ("dense", "indexless", "folded")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Ops at these sizes gain nothing from intra-op threads; one thread
    keeps this module from oversubscribing the cores that parallel test
    workers share (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def buy_request_address(pkg):
    """TPC-W Buy Request: the customer's address with its country
    (``chip_smoke.py``'s fold)."""
    if pkg == "ref":
        return RTemplate("buy_request_address", "address",
                         preds=(RPred("address", "addr_id"),),
                         joins=(RJoin("addr_co_id", "country"),), limit=1)
    return QueryTemplate("buy_request_address", "address",
                         preds=(Pred("address", "addr_id"),),
                         joins=(Join("addr_co_id", "country"),), limit=1)


def _plans(which):
    """(reference plan, port plan) for one of ``PLANS``."""
    dense = which == "dense"
    rp = ref_tpcw.build_tpcw_plan(SCALE_I, SCALE_C, dense_pk_index=dense)
    tp = tpcw.build_tpcw_plan(SCALE_I, SCALE_C, dense_pk_index=dense)
    if which == "folded":
        rp = rfold.extend_plan(rp, [buy_request_address("ref")],
                               {"buy_request_address": FOLD_CAP})
        tp = folding.extend_plan(tp, [buy_request_address("port")],
                                 {"buy_request_address": FOLD_CAP})
    return rp, tp


def _data():
    return tpcw.generate_data(np.random.default_rng(0), SCALE_I, SCALE_C)


def _overlapping(plan):
    """tests/test_planlint.py's corruption: the second template's slots
    start where the first's do."""
    names = sorted(plan.offsets, key=plan.offsets.get)
    offsets = dict(plan.offsets)
    offsets[names[1]] = plan.offsets[names[0]]
    return dataclasses.replace(plan, offsets=offsets)


def _rows(findings):
    return [(f.rule, f.location, f.severity, f.message) for f in findings]


@pytest.fixture(scope="module")
def ctx():
    """The corpus context: the index-less plan, its lowered IR, fused
    geometry and descriptor, and a lazy CPU engine with its recorded
    beats."""
    plan = tpcw.build_tpcw_plan(SCALE_I, SCALE_C, dense_pk_index=False)
    data = _data()
    key_stats = _measure_key_stats(plan, data)
    lowered = lower_plan(plan, key_stats=key_stats)
    geometry = kernel_passes.geometry_from_lowered(lowered)
    cache = {}

    def engine():
        if "engine" not in cache:
            cache["engine"] = SharedDBEngine(
                plan, tpcw.DEFAULT_UPDATE_SLOTS, data, kernels="torch",
                device="cpu", jit=False)
        return cache["engine"]

    def records():
        if "records" not in cache:
            cache["records"] = trace_passes.record_beats(engine())
        return cache["records"]

    return {"plan": plan, "data": data, "key_stats": key_stats,
            "lowered": lowered, "geometry": geometry,
            "descriptor": kernel_passes.launch_descriptor(geometry),
            "engine": engine, "records": records}


# ---------------------------------------------------------------------------
# Parity with the reference
# ---------------------------------------------------------------------------


def test_registry_holds_the_reference_rules():
    assert {k: r.family for k, r in registry.RULES.items()} == \
        {k: r.family for k, r in rregistry.RULES.items()}
    assert len(registry.RULES) == 22
    for k in ("jaxpr-delta-collective", "jaxpr-reseed-collective",
              "fold-mirror-set"):       # the sharded engine's rules
        assert dataclasses.astuple(registry.RULES[k]) == \
            dataclasses.astuple(rregistry.RULES[k])


def _corruptions(rp, tp, rlow, tlow, rstats, tstats):
    """The same corruption of both packages' plans: name -> ((ref plan,
    ref lowered, ref stats), (port ...))."""
    def scan0(low, **kw):
        return dataclasses.replace(
            low, scans=(dataclasses.replace(low.scans[0], **kw),)
            + low.scans[1:])
    names = sorted(tp.offsets, key=tp.offsets.get)
    big = {t: {"n_live": 1, "max_dup": 4096} for t in tstats}
    return {
        "clean": ((rp, rlow, rstats), (tp, tlow, tstats)),
        "overlapping": ((_overlapping(rp), rlow, rstats),
                        (_overlapping(tp), tlow, tstats)),
        "escaping_cap": tuple(
            (dataclasses.replace(p, caps=dict(p.caps, **{names[-1]: 4096})),
             low, st) for p, low, st in ((rp, rlow, rstats),
                                         (tp, tlow, tstats))),
        "window": ((rp, scan0(rlow, whi=rlow.W + 1), rstats),
                   (tp, scan0(tlow, whi=tlow.W + 1), tstats)),
        "pane": ((rp, scan0(rlow, delta_words=0), rstats),
                 (tp, scan0(tlow, delta_words=0), tstats)),
        "skew": ((rp, rlow, big), (tp, tlow, big)),
    }


@pytest.mark.parametrize("which", PLANS)
def test_ir_findings_match_the_reference(which):
    """Both packages' IR passes on the same plan, clean and corrupted
    five ways (overlapping slots, a cap past qcap, a scan window past W,
    an empty delta pane, key skew wider than the buckets): the same
    findings, rule, location, severity and message."""
    rp, tp = _plans(which)
    data = _data()
    rstats = ref_key_stats(rp, ref_tpcw.generate_data(
        np.random.default_rng(0), SCALE_I, SCALE_C))
    tstats = _measure_key_stats(tp, data)
    assert tstats == rstats
    rlow, tlow = ref_lower(rp, key_stats=rstats), lower_plan(
        tp, key_stats=tstats)
    fired = set()
    for name, ((rp_, rl_, rs_), (tp_, tl_, ts_)) in _corruptions(
            rp, tp, rlow, tlow, rstats, tstats).items():
        want = (rpasses.lint_slot_layout(rp_)
                + rpasses.lint_word_windows(rl_)
                + rpasses.lint_partition_geometry(rl_, rs_))
        got = (ir_passes.lint_slot_layout(tp_)
               + ir_passes.lint_word_windows(tl_)
               + ir_passes.lint_partition_geometry(tl_, ts_))
        assert _rows(got) == _rows(want), name
        fired |= {f.rule for f in got}
        if name == "clean":
            assert errors_in(got) == []
    assert {"ir-slot-overlap", "ir-slot-coverage",
            "ir-word-window"} <= fired
    if which != "dense":
        assert "ir-partition-geometry" in fired


def test_fold_findings_match_the_reference():
    """The fold passes on the Buy Request fold: the batch, plan- and
    IR-level prefix checks give the reference's findings on the real
    extension (none) and on it read backwards (old and new swapped)."""
    (rb, tb), (rf, tf) = _plans("indexless"), _plans("folded")
    for a, b in (("base", "folded"), ("folded", "base")):
        r = {"base": rb, "folded": rf}
        t = {"base": tb, "folded": tf}
        assert _rows(ir_passes.lint_plan_prefix(t[a], t[b])) == \
            _rows(rpasses.lint_plan_prefix(r[a], r[b]))
        got = ir_passes.lint_extension_prefix(lower_plan(t[a]),
                                              lower_plan(t[b]))
        assert _rows(got) == _rows(rpasses.lint_extension_prefix(
            ref_lower(r[a]), ref_lower(r[b])))
        assert bool(got) == (a == "folded")
    dup = next(iter(tb.templates.values()))
    rdup = rb.templates[dup.name]
    assert _rows(ir_passes.lint_fold_batch(tb, [dup, dup], {dup.name: 0})) \
        == _rows(rpasses.lint_fold_batch(rb, [rdup, rdup], {dup.name: 0}))


# ---------------------------------------------------------------------------
# The construction gate
# ---------------------------------------------------------------------------


def test_construction_gate_refuses_what_the_reference_refuses(ctx):
    """The overlapping-offsets plan: the reference's engine and the
    port's both raise PlanLintError naming ir-slot-overlap at
    construction; the untouched plan builds."""
    slots = tpcw.DEFAULT_UPDATE_SLOTS
    rplan = ref_tpcw.build_tpcw_plan(SCALE_I, SCALE_C, dense_pk_index=False)
    rdata = ref_tpcw.generate_data(np.random.default_rng(0), SCALE_I,
                                   SCALE_C)
    with pytest.raises(RPlanLintError, match="ir-slot-overlap"):
        RefEngine(_overlapping(rplan), slots, rdata, jit=False)
    with pytest.raises(PlanLintError, match="ir-slot-overlap") as got:
        SharedDBEngine(_overlapping(ctx["plan"]), slots, ctx["data"],
                       kernels="torch", device="cpu")
    assert "[planlint:ir-slot-overlap] template[" in str(got.value)
    eng = ctx["engine"]()
    assert len(eng.gate_s) == 1 and 0 < eng.gate_s[0] < 1.0


def test_fold_gate_runs_on_the_fold_thread(ctx, monkeypatch):
    """A fold whose extended plan overlaps slots: the build on the fold
    thread stops at the gate (nothing lowered is built, no generation is
    added) and the commit raises with the PlanLintError as its cause."""
    plan, data = ctx["plan"], ctx["data"]
    eng = SharedDBEngine(plan, tpcw.DEFAULT_UPDATE_SLOTS, data,
                         kernels="torch", device="cpu")
    real = folding.extend_plan

    def corrupt(plan, new, caps):
        ext = real(plan, new, caps)
        offsets = dict(ext.offsets)
        offsets[new[0].name] = min(plan.offsets.values())
        return dataclasses.replace(ext, offsets=offsets)

    monkeypatch.setattr(folding, "extend_plan", corrupt)
    eng.begin_fold([buy_request_address("port")],
                   {"buy_request_address": FOLD_CAP}, background=True)
    eng._fold.thread.join(timeout=60)
    assert eng.fold_ready()
    assert isinstance(eng._fold.error, PlanLintError)
    assert "ir-slot-overlap" in str(eng._fold.error)
    assert eng._fold.handle is None and len(eng.capture_stats) == 1
    with pytest.raises(RuntimeError, match="failed to build") as got:
        eng.dispatch()
    assert isinstance(got.value.__cause__, PlanLintError)


# ---------------------------------------------------------------------------
# The port's own proofs, clean on the shipped plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", PLANS)
def test_kernel_passes_clean_and_geometry_is_the_wrappers(which):
    """The fused geometry from the lowered plan is the reference's (its
    ScanGeom / JoinGeom fields) and the one the fused_delta wrapper
    computes at a recorded delta-join call; the descriptor
    launch_schedule builds for it passes every kernel pass at an H100's
    132 SMs and at one SM."""
    rp, tp = _plans(which)
    data = _data()
    ks = _measure_key_stats(tp, data)
    low = lower_plan(tp, key_stats=ks)
    geom = kernel_passes.geometry_from_lowered(low)
    rs, rj = ref_geometry(ref_lower(rp, key_stats=ks))
    assert [tuple(g) for g in geom.sgeom] == [tuple(g) for g in rs]
    assert [tuple(g) for g in geom.jgeom] == [tuple(g) for g in rj]
    desc, n_block = kernel_passes.launch_descriptor(geom)
    for sms in (132, 1):
        assert errors_in(kernel_passes.run_kernel_passes(
            geom, desc, n_block, sms=sms)) == []
    if not geom.jgeom:
        return
    # the wrapper's geometry at a real call: one delta-join body of a
    # CPU engine on a backend that keeps fused_delta's inputs
    calls = []
    torch_be = backends.get_backend("torch")

    def keep(scan_in, join_in):
        calls.append((scan_in, join_in))
        return torch_be.fused_delta(scan_in, join_in)

    backends.register_backend(dataclasses.replace(
        torch_be, name="torch-keeping", fused_delta=keep))
    eng = SharedDBEngine(tp, tpcw.DEFAULT_UPDATE_SLOTS, data,
                         kernels="torch-keeping", device="cpu", jit=False)
    for _ in range(2):
        eng.submit_update("customer", "update",
                          {"key": 3, "col": "c_expiration", "val": 900})
        eng.run_cycle()
    assert eng.last_join_path == "delta" and calls
    got = kernel_passes.geometry_from_inputs(*calls[-1])
    assert got == geom
    rows = tuple(e.rows.numpy() for e in calls[-1][1])
    assert errors_in(kernel_passes.lint_garbage_park(
        geom, desc, dirty_rows=rows)) == []


@pytest.mark.parametrize("which", PLANS)
def test_trace_passes_clean_on_the_shipped_plans(which):
    """One recorded body of each flavour on a CPU engine: no full-window
    compare on the delta paths, the state (and on the delta flavours the
    scan carry) rolled forward in place and nothing else of the body's
    inputs, the fixed buffers disjoint."""
    _, tp = _plans(which)
    eng = SharedDBEngine(tp, tpcw.DEFAULT_UPDATE_SLOTS, _data(),
                         kernels="torch", device="cpu", jit=False)
    recs = trace_passes.record_beats(eng)
    assert recs["full"].wrote == {"state", "carry", "out"}
    assert recs["delta"].wrote == recs["delta_join"].wrote == \
        {"state", "carry", "out"}
    assert any(op == "ge" for op, _ in recs["delta"].compares)
    fs = trace_passes.run_trace_passes(eng)
    assert errors_in(fs) == [], fs


def test_source_pass_clean():
    assert source_passes.lint_hot_path_asserts() == []
    bad = source_passes.lint_source_text("def f(x):\n    assert x\n", "m.py")
    assert [f.rule for f in bad] == ["no-bare-assert"]


# ---------------------------------------------------------------------------
# Seeded-mutation corpus
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CORPUS)
def test_corpus_mutation_caught(ctx, name):
    mod = importlib.import_module(f"torch_lint_corpus.{name}")
    assert mod.EXPECT in registry.RULES, f"{name}: EXPECT names unknown rule"
    errs = errors_in(mod.findings(ctx))
    assert errs, f"{name}: mutation produced no error findings"
    got = {f.rule for f in errs}
    assert mod.EXPECT in got, (name, mod.EXPECT, got)


# ---------------------------------------------------------------------------
# The CLI and the import
# ---------------------------------------------------------------------------


def test_cli_exit_codes(monkeypatch, capsys):
    """0 on both workloads, 1 on a corrupted plan; a negative shard count
    and hopper on the CPU raise instead of skipping; --rules lists 22."""
    assert lint.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[  ok] tpcw/torch" in out and "[  ok] tpcw-nopk/torch" in out
    real = lint._build_plan
    monkeypatch.setattr(lint, "_build_plan",
                        lambda *a: (lambda p, d: (_overlapping(p), d))(
                            *real(*a)))
    assert lint.main(["--device", "cpu", "--workloads", "tpcw"]) == 1
    assert "ir-slot-overlap" in capsys.readouterr().out
    with pytest.raises(ValueError, match="a shard count is >= 0"):
        lint.main(["--device", "cpu", "--shards", "-1"])
    with pytest.raises(ValueError, match="needs the CUDA card"):
        lint.main(["--device", "cpu", "--backends", "hopper"])
    assert lint.main(["--rules"]) == 0
    assert "22 rules" in capsys.readouterr().out


def test_import_is_free_of_jax_and_the_reference():
    code = ("import sys\n"
            "import repro_torch.analysis_static\n"
            "from repro_torch.analysis_static import ir_passes, "
            "kernel_passes, lint, source_passes, trace_passes\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.')) or m == 'repro')\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    src = Path(__file__).resolve().parents[1] / "src"
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=src,
                       env=dict(os.environ, PYTHONPATH=str(src)))
    assert r.returncode == 0, r.stdout + r.stderr
