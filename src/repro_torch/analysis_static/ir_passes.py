"""IR passes: structural lint over ``CompiledPlan`` + the staged
lowering IR (``LoweredPlan``), the port's counterparts of the JAX
package's ``repro.analysis_static.ir_passes`` with the same findings
(rule, location, severity, message).

These are the cheap, always-on passes: ``SharedDBEngine._build_compiled``
runs ``run_construction_passes`` on every generation it lowers (cold
start AND every background fold build), before any buffer is allocated
or any graph captured, and ``folding.extend_plan`` / ``begin_fold`` /
``lowering.check_extension_prefix`` route fold admission through the
``lint_fold_*`` passes; ``sharding.check_fold_mirrors`` (a fold under a
mesh) through ``lint_fold_mirrors``.  Pure Python over the host IR:
nothing here touches a device.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.analysis_static.diagnostics import (LintFinding,
                                                     raise_on_error)
from repro_torch.analysis_static import registry as R
from repro_torch.analysis_static.registry import register_pass


# ---------------------------------------------------------------------------
# Plan-level: admission slot layout
# ---------------------------------------------------------------------------


@register_pass("slot-layout", "ir",
               (R.IR_SLOT_OVERLAP, R.IR_SLOT_COVERAGE),
               "slot-range disjointness and qcap coverage")
def lint_slot_layout(plan) -> List[LintFinding]:
    """Template slot ranges: positive caps, inside qcap, disjoint."""
    out = []
    if plan.qcap <= 0 or plan.qcap % 32:
        out.append(LintFinding(
            R.IR_SLOT_COVERAGE,
            f"qcap {plan.qcap} is not a positive multiple of 32"))
    missing = set(plan.templates) ^ set(plan.offsets)
    missing |= set(plan.templates) ^ set(plan.caps)
    if missing:
        out.append(LintFinding(
            R.IR_SLOT_COVERAGE,
            f"templates without slot ranges (or vice versa): "
            f"{sorted(missing)}"))
        return out
    ranges = sorted((plan.offsets[n], plan.caps[n], n)
                    for n in plan.templates)
    prev_end, prev_name = 0, None
    for off, cap, name in ranges:
        loc = f"template[{name}]"
        if cap < 1:
            out.append(LintFinding(
                R.IR_SLOT_COVERAGE, f"slot capacity {cap} < 1",
                location=loc))
        if off < 0 or off + cap > plan.qcap:
            out.append(LintFinding(
                R.IR_SLOT_COVERAGE,
                f"slot range [{off}, {off + cap}) escapes qcap "
                f"{plan.qcap}", location=loc))
        if off < prev_end:
            out.append(LintFinding(
                R.IR_SLOT_OVERLAP,
                f"slot range [{off}, {off + cap}) overlaps "
                f"{prev_name!r} (ends at {prev_end})", location=loc))
        if off + cap > prev_end:
            prev_end, prev_name = off + cap, name
    return out


# ---------------------------------------------------------------------------
# IR-level: per-stage windows, masks, scatter plans
# ---------------------------------------------------------------------------


def _lint_slots_in_window(slots, q_window: int, loc: str
                          ) -> List[LintFinding]:
    out = []
    for name, off, cap in slots:
        if off < 0 or off + cap > q_window:
            out.append(LintFinding(
                R.IR_WORD_WINDOW,
                f"slot range of {name!r} ([{off}, {off + cap})) escapes "
                f"the stage window ({q_window} slots)", location=loc))
    return out


@register_pass("word-windows", "ir", (R.IR_WORD_WINDOW,),
               "per-stage word-window / mask / scatter-plan bounds")
def lint_word_windows(lowered) -> List[LintFinding]:
    """Every stage's word window, subscriber mask and predicate scatter
    plan stays inside the global [0, W) mask and its own window."""
    out = []
    W = lowered.W
    for st in lowered.scans:
        loc = f"scan[{st.table}]"
        if not (0 <= st.wlo <= st.whi <= W):
            out.append(LintFinding(
                R.IR_WORD_WINDOW,
                f"word window [{st.wlo}, {st.whi}) escapes [0, {W})",
                location=loc))
            continue
        qw = st.q_window
        if st.covered.shape != (qw,):
            out.append(LintFinding(
                R.IR_WORD_WINDOW,
                f"covered mask shape {st.covered.shape} != ({qw},)",
                location=loc))
        want = (max(len(st.cols), 1), qw)
        if st.param_idx.shape != want:
            out.append(LintFinding(
                R.IR_WORD_WINDOW,
                f"param_idx shape {st.param_idx.shape} != {want}",
                location=loc))
        elif st.param_idx.size and (
                st.param_idx.min() < -1
                or st.param_idx.max() >= lowered.n_params_max):
            out.append(LintFinding(
                R.IR_WORD_WINDOW,
                f"param_idx values escape [-1, {lowered.n_params_max})",
                location=loc))
        if st.cols and not (1 <= st.delta_words <= st.whi - st.wlo):
            out.append(LintFinding(
                R.IR_WORD_WINDOW,
                f"delta pane ({st.delta_words} words) escapes the "
                f"window ({st.whi - st.wlo} words)", location=loc))
        out += _lint_slots_in_window(st.slots, qw, loc)
        if st.covered.shape == (qw,):
            for name, off, cap in st.slots:
                if 0 <= off and off + cap <= qw \
                        and not st.covered[off:off + cap].all():
                    out.append(LintFinding(
                        R.IR_WORD_WINDOW,
                        f"slots of {name!r} not marked covered",
                        location=loc))
    for j in lowered.joins:
        loc = f"join[{j.spine}->{j.pk_table}]"
        if j.sub_mask.shape != (W,):
            out.append(LintFinding(
                R.IR_WORD_WINDOW,
                f"subscriber mask shape {j.sub_mask.shape} != ({W},)",
                location=loc))
    for kind, st in list(lowered.stages())[len(lowered.scans)
                                           + len(lowered.joins):]:
        loc = f"{kind}[{st.spine}]"
        if not (0 <= st.wlo <= st.whi <= W):
            out.append(LintFinding(
                R.IR_WORD_WINDOW,
                f"word window [{st.wlo}, {st.whi}) escapes [0, {W})",
                location=loc))
            continue
        if hasattr(st, "sub_mask") and \
                st.sub_mask.shape != (st.whi - st.wlo,):
            out.append(LintFinding(
                R.IR_WORD_WINDOW,
                f"window-local mask shape {st.sub_mask.shape} != "
                f"({st.whi - st.wlo},)", location=loc))
        if st.union_cap < 1:
            out.append(LintFinding(
                R.IR_WORD_WINDOW, f"union cap {st.union_cap} < 1",
                location=loc))
        out += _lint_slots_in_window(st.slots, (st.whi - st.wlo) * 32,
                                     loc)
    if lowered.limits.shape != (lowered.qcap,):
        out.append(LintFinding(
            R.IR_WORD_WINDOW,
            f"limits shape {lowered.limits.shape} != ({lowered.qcap},)"))
    elif lowered.limits.size and (
            lowered.limits.min() < 1
            or lowered.limits.max() > lowered.plan.max_results):
        out.append(LintFinding(
            R.IR_WORD_WINDOW,
            f"per-slot limits escape [1, {lowered.plan.max_results}]"))
    return out


@register_pass("partition-geometry", "ir", (R.IR_PARTITION_GEOMETRY,),
               "bucket geometry vs capacity and measured key skew")
def lint_partition_geometry(lowered,
                            key_stats: Optional[Dict] = None
                            ) -> List[LintFinding]:
    """Partitioned joins: buckets must cover the PK capacity, and under
    measured ``key_stats`` the bucket width must hold the widest
    duplicate run AND reproduce ``partition_layout`` exactly (the
    carried partitions remap across folds only if geometry is a pure
    function of (capacity, stats))."""
    from repro_torch.core.lowering import partition_layout
    out = []
    cat = lowered.plan.catalog
    for j in lowered.joins:
        loc = f"join[{j.spine}->{j.pk_table}]"
        cap = cat.schemas[j.pk_table].capacity
        if j.kind != "partitioned":
            if (j.n_partitions, j.bucket_cap) != (0, 0):
                out.append(LintFinding(
                    R.IR_PARTITION_GEOMETRY,
                    f"{j.kind} join carries partition geometry "
                    f"({j.n_partitions}x{j.bucket_cap})", location=loc))
            continue
        if j.n_partitions < 1 or j.bucket_cap < 1:
            out.append(LintFinding(
                R.IR_PARTITION_GEOMETRY,
                f"degenerate geometry {j.n_partitions}x{j.bucket_cap}",
                location=loc))
            continue
        if j.n_partitions * j.bucket_cap < cap:
            out.append(LintFinding(
                R.IR_PARTITION_GEOMETRY,
                f"partition capacity {j.n_partitions}x{j.bucket_cap} "
                f"= {j.n_partitions * j.bucket_cap} < table capacity "
                f"{cap} (build_key_partitions would overflow)",
                location=loc))
        if key_stats is not None:
            stats = key_stats.get(j.pk_table)
            if stats and j.bucket_cap < int(stats.get("max_dup", 1)):
                out.append(LintFinding(
                    R.IR_PARTITION_GEOMETRY,
                    f"bucket capacity {j.bucket_cap} < measured widest "
                    f"duplicate run {stats['max_dup']}", location=loc))
            want = partition_layout(cap, stats)
            if (j.n_partitions, j.bucket_cap) != want:
                out.append(LintFinding(
                    R.IR_PARTITION_GEOMETRY,
                    f"geometry {j.n_partitions}x{j.bucket_cap} != "
                    f"partition_layout{want} for the measured stats "
                    "(folds could not remap carried partitions)",
                    location=loc))
    return out


def run_construction_passes(lowered, key_stats: Optional[Dict] = None
                            ) -> List[LintFinding]:
    """The always-on bundle: raise ``PlanLintError`` on any error."""
    findings = (lint_slot_layout(lowered.plan)
                + lint_word_windows(lowered)
                + lint_partition_geometry(lowered, key_stats))
    return raise_on_error(findings)


# ---------------------------------------------------------------------------
# Fold admission passes (folding.extend_plan / begin_fold route here)
# ---------------------------------------------------------------------------


@register_pass("fold-batch", "fold",
               (R.FOLD_DUPLICATE_TEMPLATE, R.FOLD_DUPLICATE_IN_BATCH,
                R.FOLD_ZERO_CAP, R.FOLD_ALIEN_TABLE,
                R.FOLD_UNKNOWN_COLUMN),
               "fold-batch admission: names, caps, referenced schema")
def lint_fold_batch(plan, new_templates, new_caps) -> List[LintFinding]:
    out = []
    for t in new_templates:
        loc = f"template[{t.name}]"
        if t.name in plan.templates:
            out.append(LintFinding(
                R.FOLD_DUPLICATE_TEMPLATE,
                f"template {t.name!r} already in the plan",
                location=loc))
        if t.name not in new_caps or new_caps[t.name] < 1:
            out.append(LintFinding(
                R.FOLD_ZERO_CAP,
                f"template {t.name!r} needs a positive cap "
                f"(got {new_caps.get(t.name)!r})", location=loc))
        for table in t.tables():
            if table not in plan.catalog.schemas:
                out.append(LintFinding(
                    R.FOLD_ALIEN_TABLE,
                    f"template {t.name!r} references unknown table "
                    f"{table!r} — folding admits new query shapes, not "
                    "new tables", location=loc))
        for p in t.preds:
            if p.table not in plan.catalog.schemas or \
                    p.col not in plan.catalog.schemas[p.table].columns:
                out.append(LintFinding(
                    R.FOLD_UNKNOWN_COLUMN,
                    f"template {t.name!r} predicate on unknown column "
                    f"{p.table}.{p.col}", location=loc))
    names = [t.name for t in new_templates]
    if len(set(names)) != len(names):
        dupes = sorted({n for n in names if names.count(n) > 1})
        out.append(LintFinding(
            R.FOLD_DUPLICATE_IN_BATCH,
            f"duplicate template names in the fold batch: {dupes}"))
    return out


@register_pass("plan-prefix", "fold", (R.FOLD_PLAN_PREFIX,),
               "plan-level prefix stability of an extension")
def lint_plan_prefix(old, new) -> List[LintFinding]:
    """Prefix stability at the PLAN level (the IR level is re-proved by
    ``lint_extension_prefix`` after the extended plan lowers)."""
    out = []

    def bad(msg):
        out.append(LintFinding(R.FOLD_PLAN_PREFIX, msg))

    for name in old.templates:
        if new.offsets.get(name) != old.offsets[name] or \
                new.caps.get(name) != old.caps[name]:
            bad(f"slot range of existing template {name!r} moved "
                f"({old.offsets[name]}+{old.caps[name]} -> "
                f"{new.offsets.get(name)}+{new.caps.get(name)})")
    if new.qcap < old.qcap:
        bad(f"qcap shrank ({old.qcap} -> {new.qcap})")
    old_scan_keys = list(old.scans)
    if list(new.scans)[:len(old_scan_keys)] != old_scan_keys:
        bad("scan node order changed")
    else:
        for table in old_scan_keys:
            oc, nc = old.scans[table].cols, new.scans[table].cols
            if tuple(nc[:len(oc)]) != tuple(oc):
                bad(f"scan {table!r} columns reordered")
    ok = [(j.spine, j.fk_col, j.pk_table) for j in old.joins]
    if [(j.spine, j.fk_col, j.pk_table)
            for j in new.joins[:len(ok)]] != ok:
        bad("join node order changed")
    osk = [(s.spine, s.col, s.desc) for s in old.sorts]
    if [(s.spine, s.col, s.desc) for s in new.sorts[:len(osk)]] != osk:
        bad("sort node order changed")
    ogk = [(g.spine, g.agg.group_col, g.agg.agg_col) for g in old.groups]
    if [(g.spine, g.agg.group_col, g.agg.agg_col)
            for g in new.groups[:len(ogk)]] != ogk:
        bad("group node order changed")
    return out


@register_pass("extension-prefix", "fold", (R.FOLD_PREFIX_STABILITY,),
               "IR-level prefix stability of an extension")
def lint_extension_prefix(old, new) -> List[LintFinding]:
    """Prefix stability re-proved on the LOWERED IR — the contract
    carry migration (``folding.migrate_carry``) rests on.  Every
    derivation ``lower_plan`` makes for an appended-template extension
    (stage positions fixed, windows widen high-side only, predicate
    columns append, join access paths frozen) becomes a hard finding."""
    out = []

    def bad(what):
        out.append(LintFinding(
            R.FOLD_PREFIX_STABILITY,
            f"plan extension is not prefix-stable: {what} — the fold "
            "cannot migrate carries into this layout"))

    if new.qcap < old.qcap or new.n_params_max < old.n_params_max:
        bad(f"global capacity shrank (qcap {old.qcap}->{new.qcap}, "
            f"P_max {old.n_params_max}->{new.n_params_max})")
    if len(new.scans) < len(old.scans):
        bad("scan stage list shrank")
    for os_, ns in zip(old.scans, new.scans):
        if ns.table != os_.table:
            bad(f"scan stage order changed ({os_.table} -> {ns.table})")
        if ns.wlo != os_.wlo or ns.whi < os_.whi:
            bad(f"scan window of {os_.table} moved "
                f"([{os_.wlo},{os_.whi}) -> [{ns.wlo},{ns.whi}))")
        if tuple(ns.cols[:len(os_.cols)]) != tuple(os_.cols):
            bad(f"predicated columns of {os_.table} reordered "
                f"({os_.cols} -> {ns.cols})")
    if [j.key for j in new.joins[:len(old.joins)]] != \
            [j.key for j in old.joins]:
        bad("join stage order changed")
    for oj, nj in zip(old.joins, new.joins):
        if (nj.kind, nj.n_partitions, nj.bucket_cap) != \
                (oj.kind, oj.n_partitions, oj.bucket_cap):
            bad(f"join {oj.key} access path changed "
                f"({oj.kind} -> {nj.kind})")
    old_sorts = [(s.spine, s.col, s.desc) for s in old.sorts]
    if [(s.spine, s.col, s.desc) for s in new.sorts[:len(old_sorts)]] \
            != old_sorts:
        bad("sort stage order changed")
    old_groups = [(g.spine, g.agg.group_col, g.agg.agg_col)
                  for g in old.groups]
    if [(g.spine, g.agg.group_col, g.agg.agg_col)
            for g in new.groups[:len(old_groups)]] != old_groups:
        bad("group stage order changed")
    if [r.spine for r in new.routes[:len(old.routes)]] != \
            [r.spine for r in old.routes]:
        bad("route stage order changed")
    return out


@register_pass("fold-mirrors", "fold", (R.FOLD_MIRROR_SET,),
               "mesh folds keep the mirrored table set fixed")
def lint_fold_mirrors(old_plan, new_plan) -> List[LintFinding]:
    """A fold under a mesh must keep the sharded STATE layout fixed:
    the mirrored (replicated probe side) table set is decided by join
    membership, and flipping a table would demand a cross-shard state
    migration mid-serve."""
    old_m = {j.pk_table for j in old_plan.joins}
    new_m = {j.pk_table for j in new_plan.joins}
    if old_m != new_m:
        return [LintFinding(
            R.FOLD_MIRROR_SET,
            "fold under a mesh would change the mirrored table set "
            f"({sorted(old_m ^ new_m)}) — the sharded state layout is "
            "fixed at startup; register templates whose joins target "
            "already-mirrored PK tables, or restart to re-shard")]
    return []
