"""Port parity, plan folding: ``repro_torch.core.folding`` and the
executor's fold lifecycle held to the JAX package's on the same seeded
numpy inputs, at scale 64/128 on the index-less catalog.

  * ``extend_plan`` extends the plan as the reference does, and the same
    bad folds are rejected with the same planlint findings (rule ids and
    messages), by each of the three admission / prefix checks;
  * ``migrate_carry`` gives the reference's carries on the same carries;
  * a single-device fold-differential stream through both packages'
    ``QueryCycleServer``: the reference's split (10 templates compiled,
    the last three registered mid-stream as one batch), then TPC-W's Buy
    Request address lookup (``address`` joined to the 92-row ``country``
    table, a block join), folded while serving, with the port's build in
    the foreground and on the background thread.  Tickets, paths,
    backend launch counts and every table's snapshot are equal on every
    beat;
  * a second fold while one is in flight raises, and the
    ``delta_scans`` / ``delta_joins`` switches give the reference's
    paths;
  * under ``python -O`` (a subprocess) the carry/layout guard and a
    stale-carry ``dispatch()`` raise, and the three guards converted
    from bare asserts raise with their planlint rule id, whose messages
    equal the reference's (``run_torch_fold_differential.py`` is the
    whole leg).

The reference runs with ``jit=False``, ``kernels="jnp"``, ``mesh=None``;
its stream runs once per module and the port's streams are held to it.
"""
import os
import subprocess
import sys
import textwrap
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis_static import ir_passes as rpasses
from repro.analysis_static.diagnostics import format_findings
from repro.core import folding as rfold
from repro.core.executor import SharedDBEngine as RefEngine
from repro.core.lowering import lower_plan as ref_lower
from repro.core.plan import Join as RJoin
from repro.core.plan import Pred as RPred
from repro.core.plan import QueryTemplate as RTemplate
from repro.core.plan import compile_plan as ref_compile
from repro.serving import QueryCycleServer as RefServer
from repro.workloads import tpcw as ref_tpcw
from repro_torch.analysis_static import diagnostics as tdiag
from repro_torch.analysis_static import ir_passes as tpasses
from repro_torch.core import folding
from repro_torch.core.executor import SharedDBEngine
from repro_torch.core.lowering import check_extension_prefix, lower_plan
from repro_torch.core.plan import Join, Pred, QueryTemplate, compile_plan
from repro_torch.serving import QueryCycleServer
from repro_torch.workloads import tpcw
from run_torch_fold_differential import RULE, guard_messages

SCALE_I, SCALE_C = 64, 128
N_BASE = 10
FOLD_BATCH = ("order_lines", "order_display", "get_cart")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Ops at scale 64/128 gain nothing from intra-op threads; one thread
    keeps this module from oversubscribing the cores that parallel test
    workers share (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def buy_request_address(pkg):
    """TPC-W Buy Request: the customer's address with its country."""
    if pkg == "ref":
        return RTemplate("buy_request_address", "address",
                         preds=(RPred("address", "addr_id"),),
                         joins=(RJoin("addr_co_id", "country"),), limit=1)
    return QueryTemplate("buy_request_address", "address",
                         preds=(Pred("address", "addr_id"),),
                         joins=(Join("addr_co_id", "country"),), limit=1)


def _split(pkg):
    """(templates, caps, base plan) of the reference's fold split."""
    mod, comp = (ref_tpcw, ref_compile) if pkg == "ref" else \
        (tpcw, compile_plan)
    catalog = mod.make_catalog(SCALE_I, SCALE_C, dense_pk_index=False)
    templates, caps = mod.make_templates(catalog.schemas["item"].capacity)
    base = comp(catalog, templates[:N_BASE],
                {t.name: caps[t.name] for t in templates[:N_BASE]})
    return templates, caps, base


def _data():
    return tpcw.generate_data(np.random.default_rng(0), SCALE_I, SCALE_C)


# ------------------------------------------------------------ the plan
def test_extend_plan_matches_reference():
    (rt, rc, rbase), (tt, tc, tbase) = _split("ref"), _split("port")
    rnew = list(rt[N_BASE:]) + [buy_request_address("ref")]
    tnew = list(tt[N_BASE:]) + [buy_request_address("port")]
    caps = dict(rc, buy_request_address=16)
    rext = rfold.extend_plan(rbase, rnew, {t.name: caps[t.name]
                                           for t in rnew})
    text = folding.extend_plan(tbase, tnew, {t.name: caps[t.name]
                                             for t in tnew})
    assert list(text.templates) == list(rext.templates)
    assert text.offsets == rext.offsets and text.caps == rext.caps
    assert text.qcap == rext.qcap
    assert list(text.scans) == list(rext.scans)
    assert [(j.spine, j.fk_col, j.pk_table) for j in text.joins] == \
        [(j.spine, j.fk_col, j.pk_table) for j in rext.joins]
    for name in tbase.templates:        # existing slot ranges stay put
        assert text.offsets[name] == tbase.offsets[name]
    old, new = lower_plan(tbase), lower_plan(text)
    check_extension_prefix(old, new)
    rnew_l = ref_lower(rext)
    assert [(s.table, s.wlo, s.whi, tuple(s.cols)) for s in new.scans] == \
        [(s.table, s.wlo, s.whi, tuple(s.cols)) for s in rnew_l.scans]
    assert [(j.key, j.kind, j.n_partitions, j.bucket_cap)
            for j in new.joins] == \
        [(j.key, j.kind, j.n_partitions, j.bucket_cap)
         for j in rnew_l.joins]
    assert new.joins[-1].kind == "block"      # address -> country


def _bad_fold(case, pkg):
    templates, caps, base = _split(pkg)
    mk = (RTemplate, RPred) if pkg == "ref" else (QueryTemplate, Pred)
    t = templates[N_BASE]
    return {
        "missing_cap": lambda: ([t], {}),
        "zero_cap": lambda: ([t], {t.name: 0}),
        "name_in_use": lambda: ([templates[0]], {templates[0].name: 8}),
        "dup_in_batch": lambda: ([t, t], {t.name: 8}),
        "alien_table": lambda: ([mk[0]("alien", "no_such_table",
                                       preds=(mk[1]("no_such_table", "x"),))],
                                {"alien": 8}),
        "unknown_column": lambda: ([mk[0]("bad_col", "item",
                                          preds=(mk[1]("item", "nope"),))],
                                   {"bad_col": 8}),
    }[case](), base


@pytest.mark.parametrize("case", ["missing_cap", "zero_cap", "name_in_use",
                                  "dup_in_batch", "alien_table",
                                  "unknown_column"])
def test_extend_plan_rejects_the_reference_bad_folds(case):
    """Same bad fold, same FoldError text (rule ids included)."""
    (rt, rcaps), rbase = _bad_fold(case, "ref")
    (tt, tcaps), tbase = _bad_fold(case, "port")
    with pytest.raises(rfold.FoldError) as want:
        rfold.extend_plan(rbase, rt, rcaps)
    with pytest.raises(folding.FoldError) as got:
        folding.extend_plan(tbase, tt, tcaps)
    assert str(got.value) == str(want.value)
    assert "[planlint:fold-" in str(got.value)


def test_prefix_checks_give_the_reference_findings():
    """An extension read backwards (old and new swapped) breaks plan- and
    IR-level prefix stability: the port's two planlint passes report the
    reference's findings, and raise as the reference does."""
    (rt, rc, rbase), (tt, tc, tbase) = _split("ref"), _split("port")
    rext = rfold.extend_plan(rbase, rt[N_BASE:],
                             {t.name: rc[t.name] for t in rt[N_BASE:]})
    text = folding.extend_plan(tbase, tt[N_BASE:],
                               {t.name: tc[t.name] for t in tt[N_BASE:]})
    want = format_findings(rpasses.lint_plan_prefix(rext, rbase))
    assert want and tdiag.format_findings(
        tpasses.lint_plan_prefix(text, tbase)) == want
    with pytest.raises(folding.FoldError, match="fold-plan-prefix"):
        folding._check_plan_prefix(text, tbase)
    want = format_findings(rpasses.lint_extension_prefix(ref_lower(rext),
                                                         ref_lower(rbase)))
    got = tpasses.lint_extension_prefix(lower_plan(text), lower_plan(tbase))
    assert want and tdiag.format_findings(got) == want
    with pytest.raises(ValueError, match="fold-prefix-stability"):
        check_extension_prefix(lower_plan(text), lower_plan(tbase))


def test_migrate_carry_matches_reference():
    """The same carries migrated by both packages: width-extended words
    (zero high side) for a pure slot extension, the scan half reseeded
    for a newly predicated table, both halves for a new join stage."""
    templates, caps, base = _split("port")
    (rtemplates, rcaps, rbase) = _split("ref")
    eng = SharedDBEngine(base, tpcw.DEFAULT_UPDATE_SLOTS, _data(),
                         kernels="torch", device="cpu")
    for i in range(2):
        eng.submit_update("customer", "update",
                          {"key": 3 + i, "col": "c_expiration",
                           "val": 900 + i})
        eng.submit("get_book", {0: (5, 5)})
        eng.submit("search_author", {0: (100 + i, 120)})
        eng.run_until_drained()
    carry, rids = eng._carry, eng._rid_carry
    rcarry = {"scan": {k: jnp.asarray(v.numpy())
                       for k, v in carry["scan"].items()},
              "parts": {k: tuple(jnp.asarray(x.numpy()) for x in v)
                        for k, v in carry["parts"].items()}}
    rrids = {k: jnp.asarray(v.numpy()) for k, v in rids.items()}
    hot = ("item_hot", "item", "i_subject")
    folds = {
        "item_hot": ((QueryTemplate(hot[0], hot[1],
                                    preds=(Pred(hot[1], hot[2]),), limit=5),),
                     (RTemplate(hot[0], hot[1],
                                preds=(RPred(hot[1], hot[2]),), limit=5),),
                     32),
        "ol_probe": ((QueryTemplate("ol_probe", "order_line",
                                    preds=(Pred("order_line", "ol_o_id"),),
                                    limit=4),),
                     (RTemplate("ol_probe", "order_line",
                                preds=(RPred("order_line", "ol_o_id"),),
                                limit=4),), 8),
        "buy_request_address": ((buy_request_address("port"),),
                                (buy_request_address("ref"),), 16)}
    seen = set()
    for name, (tnew, rnew, cap) in folds.items():
        ext = folding.extend_plan(base, list(tnew),
                                  {t.name: cap for t in tnew})
        rext = rfold.extend_plan(rbase, list(rnew),
                                 {t.name: cap for t in rnew})
        got = folding.migrate_carry(eng._lowered,
                                    lower_plan(ext, key_stats=eng._key_stats),
                                    carry, rids)
        want = rfold.migrate_carry(ref_lower(rbase, key_stats=eng._key_stats),
                                   ref_lower(rext, key_stats=eng._key_stats),
                                   rcarry, rrids)
        for g, w in zip(got, want):
            assert (g is None) == (w is None), name
        seen.add(tuple(x is None for x in got))
        if got[0] is not None:
            assert sorted(got[0]["scan"]) == sorted(want[0]["scan"])
            for t, words in want[0]["scan"].items():
                np.testing.assert_array_equal(
                    got[0]["scan"][t].numpy().view(np.uint32),
                    np.asarray(words), err_msg=(name, t))
            for t, parts in want[0]["parts"].items():
                for a, b in zip(got[0]["parts"][t], parts):
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        if got[1] is not None:
            assert sorted(got[1]) == sorted(want[1])
            for k, r in want[1].items():
                np.testing.assert_array_equal(got[1][k].numpy(),
                                              np.asarray(r))
    # one pure extension, one scan reseed, one reseed of both halves
    assert seen == {(False, False), (True, False), (True, True)}


# ------------------------------------------------ fold-differential stream
def _steady_updates(beat):
    """The steady beats' trickle: customers, carts and an address whose
    customer moves country (dirty rows on the block join's spine)."""
    return [("customer", "update", {"key": 3 + beat, "col": "c_expiration",
                                    "val": 900 + beat}),
            ("shopping_cart_line", "update",
             {"key": 2 * beat, "col": "scl_qty", "val": 1 + beat % 3}),
            ("address", "update", {"key": 5 + beat, "col": "addr_co_id",
                                   "val": (7 * beat) % 92})]


# beat -> (queries, updates, registration before the beat): a reseed and
# a steady beat on the base plan, then each fold's migration beat and
# slot-stable steady beats
def _stream():
    base = [("get_book", (5, 5)), ("search_subject", (2, 2))]
    steady = [("get_book", (5, 5)), ("get_cart", (12, 12)),
              ("order_display", (9, 9)), ("order_lines", (26, 26))]
    addr = steady + [("buy_request_address", (a, a)) for a in (5, 7, 9, 11)]
    return [(base, [], None),
            (base + [("get_customer", (8, 8))], _steady_updates(1)[:1], None),
            (steady, [], "batch"),
            (steady, _steady_updates(3)[:2], None),
            (addr, [], "address"),
            (addr, _steady_updates(5), None),
            (addr, _steady_updates(6), None)]


def _record(eng, out, tickets):
    s = out[-1] if out else None
    rec = {"paths": (eng.last_scan_path, eng.last_join_path),
           "ops": dict(s.backend_ops) if s else {},
           "folds": eng.folds_done,
           "tickets": [(t.template, {k: np.asarray(v) for k, v in
                                     t.result.items()}) for t in tickets],
           "tables": {}}
    for table in eng.plan.catalog.schemas:
        snap = eng.snapshot(table)
        rec["tables"][table] = {k: np.asarray(v) for k, v in snap.items()}
    return rec


def _run_stream(pkg, background=False):
    """Drive one package's QueryCycleServer through the stream; one
    record per beat."""
    templates, caps, base = _split(pkg)
    caps = dict(caps, buy_request_address=16)
    if pkg == "ref":
        eng = RefEngine(base, ref_tpcw.DEFAULT_UPDATE_SLOTS, _data(),
                        jit=False, kernels="jnp")
        server = RefServer(eng, background_folds=False)
    else:
        eng = SharedDBEngine(base, tpcw.DEFAULT_UPDATE_SLOTS, _data(),
                             kernels="torch", device="cpu")
        server = QueryCycleServer(eng, background_folds=background)
    by_name = {t.name: t for t in templates}
    by_name["buy_request_address"] = buy_request_address(pkg)
    records = []
    for qs, ups, reg in _stream():
        if reg == "batch":
            out = server.register_templates(
                [(by_name[n], caps[n]) for n in FOLD_BATCH])
            assert [r["status"] for r in out] == ["folding"] * 3
        elif reg == "address":
            out = server.register_template(by_name["buy_request_address"],
                                           16)
            assert out["status"] == "folding"
            assert "background" in out["recipe"]["steps"][0]
        if reg and background:
            assert eng.fold_in_flight()
            deadline = time.monotonic() + 120
            while not eng.fold_ready():       # commit at THIS beat
                assert time.monotonic() < deadline, "fold build hangs"
                time.sleep(0.01)
        for u in ups:
            server.submit_update(*u)
        tickets = [server.submit(n, {0: p}) for n, p in qs]
        out = server.heartbeat()
        assert all(t.result is not None for t in tickets)
        records.append(_record(eng, out, tickets))
    return records


@pytest.fixture(scope="module")
def reference_stream():
    return _run_stream("ref")


def _equal(got, want, beat):
    assert got["paths"] == want["paths"], beat
    assert got["ops"] == want["ops"], beat
    assert got["folds"] == want["folds"], beat
    assert len(got["tickets"]) == len(want["tickets"])
    for (name, g), (_, w) in zip(got["tickets"], want["tickets"]):
        assert sorted(g) == sorted(w)
        for k in w:
            if k == "scores":
                np.testing.assert_allclose(g[k], w[k], rtol=1e-6,
                                           err_msg=(beat, name))
            else:
                np.testing.assert_array_equal(g[k], w[k],
                                              err_msg=(beat, name, k))
    assert sorted(got["tables"]) == sorted(want["tables"])
    for table, cols in want["tables"].items():
        for k, v in cols.items():
            np.testing.assert_array_equal(got["tables"][table][k], v,
                                          err_msg=(beat, table, k))


@pytest.mark.parametrize("background", [False, True])
def test_fold_differential_stream_equals_reference(reference_stream,
                                                   background):
    got = _run_stream("port", background=background)
    assert len(got) == len(reference_stream)
    for beat, (g, w) in enumerate(zip(got, reference_stream)):
        _equal(g, w, beat)
    paths = [r["paths"] for r in got]
    assert [r["folds"] for r in got] == [0, 0, 1, 1, 2, 2, 2]
    assert paths[2] == paths[4] == ("full", "full")      # migration beats
    assert paths[5] == paths[6] == ("delta", "delta")
    assert got[4]["ops"] == {"scan": 7, "join_partitioned": 4,
                             "join_block": 1, "groupby": 1}
    assert got[6]["ops"] == {"fused_delta": 1, "groupby": 1}


def test_second_fold_while_in_flight_raises():
    templates, caps, base = _split("port")
    eng = SharedDBEngine(base, tpcw.DEFAULT_UPDATE_SLOTS, _data(),
                         kernels="torch", device="cpu")
    t1, t2 = templates[N_BASE], templates[N_BASE + 1]
    eng.begin_fold([t1], {t1.name: caps[t1.name]}, background=False)
    assert eng.fold_in_flight() and eng.fold_ready()
    with pytest.raises(RuntimeError, match="fold-in-flight"):
        eng.begin_fold([t2], {t2.name: caps[t2.name]}, background=False)
    eng.submit("get_book", {0: (5, 5)})
    eng.run_until_drained()
    assert eng.folds_done == 1 and not eng.fold_in_flight()
    eng.begin_fold([t2], {t2.name: caps[t2.name]}, background=True)
    assert eng.fold_in_flight()
    eng._fold.thread.join(timeout=60)
    assert eng.fold_ready()


def test_failed_background_build_raises_at_commit(monkeypatch):
    templates, caps, base = _split("port")
    eng = SharedDBEngine(base, tpcw.DEFAULT_UPDATE_SLOTS, _data(),
                         kernels="torch", device="cpu")

    def broken(plan):
        raise MemoryError("no room for the extended plan")
    monkeypatch.setattr(eng, "_build_compiled", broken)
    t = templates[N_BASE]
    eng.begin_fold([t], {t.name: caps[t.name]}, background=True)
    eng._fold.thread.join(timeout=60)
    assert eng.fold_ready()
    eng.submit("get_book", {0: (5, 5)})
    with pytest.raises(RuntimeError, match="failed to build") as err:
        eng.dispatch()
    assert isinstance(err.value.__cause__, MemoryError)


@pytest.mark.parametrize("switch", ["delta_scans", "delta_joins"])
def test_delta_switches_give_the_reference_paths(switch):
    """With a delta switch off, both packages take the same paths beat by
    beat and answer the same (the base plan of the stream above)."""
    _, _, base = _split("port")
    _, _, rbase = _split("ref")
    port = SharedDBEngine(base, tpcw.DEFAULT_UPDATE_SLOTS, _data(),
                          kernels="torch", device="cpu", **{switch: False})
    ref = RefEngine(rbase, ref_tpcw.DEFAULT_UPDATE_SLOTS, _data(),
                    jit=False, kernels="jnp", **{switch: False})
    paths = []
    for b in range(2):
        pairs = []
        for eng in (port, ref):
            if b:
                eng.submit_update(*_steady_updates(b)[0])
            pairs.append(eng.submit("search_author", {0: (100 + b, 120)}))
            eng.run_until_drained()
        paths.append((port.last_scan_path, port.last_join_path))
        assert paths[-1] == (ref.last_scan_path, ref.last_join_path)
        np.testing.assert_array_equal(pairs[0].result["rows"],
                                      np.asarray(pairs[1].result["rows"]))
    assert paths[1] == ("full" if switch == "delta_scans" else "delta",
                        "full")
    for k, v in ref.state["customer"].items():
        np.testing.assert_array_equal(port.state["customer"][k].numpy(),
                                      np.asarray(v), err_msg=k)


# ------------------------------------------ the guards under python -O
_O_SCRIPT = textwrap.dedent("""
    import sys
    sys.path[:0] = ["src", "tests"]
    assert False, "asserts must be stripped under -O"
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from repro_torch.core.executor import SharedDBEngine, check_carry_layout
    from repro_torch.workloads import tpcw
    from run_torch_fold_differential import RULE, guard_messages

    try:
        check_carry_layout(("stale",), ("fresh",))
    except RuntimeError:
        print("GUARD_FN_OK")

    plan = tpcw.build_tpcw_plan(16, 32)
    eng = SharedDBEngine(plan, tpcw.DEFAULT_UPDATE_SLOTS,
                         tpcw.generate_data(np.random.default_rng(0),
                                            16, 32),
                         jit=False, kernels="torch", device="cpu")
    eng.submit("get_book", {0: (5, 5)})
    eng.run_until_drained()
    eng.submit("get_book", {0: (5, 5)})      # delta-eligible beat
    eng._carry_token = ("stale",)            # carry from another layout
    try:
        eng.dispatch()
    except RuntimeError as e:
        if "admission layout" in str(e):
            print("GUARD_DISPATCH_OK")

    for what, msg in guard_messages("cpu").items():
        if msg is not None and RULE in msg:
            print("RULE_ID_OK", what)
""")


def test_carry_layout_guard_survives_python_O():
    """The port's guards hold with assertions disabled: the carry/layout
    check and a stale-carry ``dispatch()`` raise, and the three guards
    converted from bare asserts raise with their planlint rule id."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-O", "-c", _O_SCRIPT],
                         capture_output=True, text=True, timeout=600,
                         cwd=repo)
    why = (out.stdout, out.stderr[-2000:])
    assert out.returncode == 0, why
    assert "GUARD_FN_OK" in out.stdout, why
    assert "GUARD_DISPATCH_OK" in out.stdout, why
    ok = {line.split()[1] for line in out.stdout.splitlines()
          if line.startswith("RULE_ID_OK ")}
    assert ok == {"bulk_load", "mask_width", "build_key_partitions"}, why


def test_stripped_assert_guards_give_the_reference_messages():
    """Without -O: the three guards raise the reference's messages, rule
    id included, on the same inputs."""
    from repro.core.dataquery import mask_width as ref_mask_width
    from repro.core.storage import bulk_load as ref_bulk_load
    from repro.core.storage import build_key_partitions as ref_partitions
    got = guard_messages("cpu")
    schema = ref_tpcw.make_catalog(SCALE_I, SCALE_C).schemas["country"]
    keys = jnp.zeros(9, jnp.int32)
    probes = {"bulk_load": lambda: ref_bulk_load(
                  schema, {c: np.zeros(schema.capacity + 1, np.int32)
                           for c in schema.columns}),
              "mask_width": lambda: ref_mask_width(33),
              "build_key_partitions": lambda: ref_partitions(
                  keys, keys == 0, 2, 4)}
    assert sorted(got) == sorted(probes)
    for what, probe in probes.items():
        with pytest.raises(ValueError) as want:
            probe()
        assert got[what] == str(want.value), what
        assert got[what].startswith(RULE), what
