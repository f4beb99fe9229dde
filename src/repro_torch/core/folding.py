"""Dynamic plan folding: admit new query templates into the running
shared plan without stopping the world.

SharedDB compiles ONE global plan at startup, which freezes the template
set.  Folding re-compiles an EXTENDED plan (new templates appended; every
existing template keeps its slot range and every existing stage keeps
its position — ``extend_plan`` and ``lowering.check_extension_prefix``
enforce this) in the background while the OLD cycles keep serving, then
swaps the cycle handle atomically at a beat boundary:

  1. ``begin_fold``   — validate the extension, start the background
                        re-lower and cycle build (the old plan keeps
                        beating; runtime/elastic.relower_recipe's
                        ``background`` variant);
  2. migration beat   — at the next dispatch after the new handle is
                        ready: drain in-flight beats, install the new
                        handle, width-extend the carries into the new
                        per-stage windows (``migrate_carry``) and version
                        the swap through the executor's ``_layout_token``
                        / ``_carry_token`` pair;
  3. reseed beat      — the FIRST post-fold heartbeat is a forced full
                        rescan, which reseeds both carry halves under the
                        new layout; from then on the engine answers as a
                        cold engine compiled with the extended template
                        set.

Carry-migration contract: the carried scan words are positional in the
admission layout — word window [wlo, whi) of each stage, bit q = "row
matches slot q".  Slots a fold appends have never been admitted, and an
un-admitted slot's predicate binds to (INT_MAX, INT_MIN), which no row
matches, so their carried bits are exactly 0: width-extending a stage's
words is a zero-pad on the high side.  Key partitions depend only on the
PK snapshot and the partition geometry (unchanged), rid arrays only on
the spine fk column and the PK snapshot — both pass through.  A half the
fold cannot migrate (a table newly predicated, a new join stage) is
returned as ``None`` and reseeds instead.

The admission and prefix-stability checks are this package's own copies
of the reference's planlint passes (``lint_fold_batch``,
``lint_plan_prefix``, ``lint_extension_prefix``): the same findings,
each message tagged ``[planlint:<rule-id>]`` with the same rule ids.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch.nn.functional as F

from repro_torch.core.lowering import LoweredPlan, check_extension_prefix
from repro_torch.core.plan import CompiledPlan, QueryTemplate, compile_plan

# rule ids (the reference's analysis_static/registry.py names)
FOLD_DUPLICATE_TEMPLATE = "fold-duplicate-template"
FOLD_DUPLICATE_IN_BATCH = "fold-duplicate-in-batch"
FOLD_ZERO_CAP = "fold-zero-cap"
FOLD_ALIEN_TABLE = "fold-alien-table"
FOLD_UNKNOWN_COLUMN = "fold-unknown-column"
FOLD_PLAN_PREFIX = "fold-plan-prefix"
FOLD_PREFIX_STABILITY = "fold-prefix-stability"
FOLD_IN_FLIGHT = "fold-in-flight"


class FoldError(ValueError):
    """A requested fold cannot preserve the running plan as a prefix."""


def finding(rule: str, message: str, location: str = "") -> str:
    """One diagnostic line: ``[planlint:<rule>] <location>: <message>``."""
    where = f" {location}:" if location else ""
    return f"[planlint:{rule}]{where} {message}"


def raise_on(findings: List[str], exc=FoldError) -> None:
    """Raise ``exc`` with every finding, one per line, if there is any."""
    if findings:
        raise exc("\n".join(findings))


# ------------------------------------------------------------ the checks
def lint_fold_batch(plan: CompiledPlan, new_templates, new_caps
                    ) -> List[str]:
    """Fold-batch admission: names, caps, referenced schema."""
    out = []
    for t in new_templates:
        loc = f"template[{t.name}]"
        if t.name in plan.templates:
            out.append(finding(FOLD_DUPLICATE_TEMPLATE,
                               f"template {t.name!r} already in the plan",
                               loc))
        if t.name not in new_caps or new_caps[t.name] < 1:
            out.append(finding(
                FOLD_ZERO_CAP, f"template {t.name!r} needs a positive cap "
                f"(got {new_caps.get(t.name)!r})", loc))
        for table in t.tables():
            if table not in plan.catalog.schemas:
                out.append(finding(
                    FOLD_ALIEN_TABLE,
                    f"template {t.name!r} references unknown table "
                    f"{table!r} — folding admits new query shapes, not "
                    "new tables", loc))
        for p in t.preds:
            if p.table not in plan.catalog.schemas or \
                    p.col not in plan.catalog.schemas[p.table].columns:
                out.append(finding(
                    FOLD_UNKNOWN_COLUMN,
                    f"template {t.name!r} predicate on unknown column "
                    f"{p.table}.{p.col}", loc))
    names = [t.name for t in new_templates]
    if len(set(names)) != len(names):
        dupes = sorted({n for n in names if names.count(n) > 1})
        out.append(finding(FOLD_DUPLICATE_IN_BATCH,
                           f"duplicate template names in the fold batch: "
                           f"{dupes}"))
    return out


def lint_plan_prefix(old: CompiledPlan, new: CompiledPlan) -> List[str]:
    """Prefix stability at the PLAN level (the IR level is re-proved by
    ``lint_extension_prefix`` after the extended plan lowers)."""
    out = []

    def bad(msg):
        out.append(finding(FOLD_PLAN_PREFIX, msg))

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


def lint_extension_prefix(old: LoweredPlan, new: LoweredPlan) -> List[str]:
    """Prefix stability re-proved on the LOWERED IR — the contract
    ``migrate_carry`` rests on (stage positions fixed, windows widen
    high-side only, predicate columns append, join access paths
    frozen)."""
    out = []

    def bad(what):
        out.append(finding(
            FOLD_PREFIX_STABILITY,
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


# ------------------------------------------------------------ the fold
def extend_plan(plan: CompiledPlan, new_templates: List[QueryTemplate],
                new_caps: Dict[str, int]) -> CompiledPlan:
    """Recompile ``plan`` with ``new_templates`` APPENDED.

    Every existing template keeps its (offset, cap) slot range, the
    global capacity only grows, and every shared node keeps its position
    (new subscribers join existing nodes; new nodes append).  New
    templates may only reference tables and columns the catalog already
    holds — folding registers QUERY shapes, not schema changes.  Raises
    ``FoldError`` naming the rule of each finding."""
    raise_on(lint_fold_batch(plan, new_templates, new_caps))
    merged = list(plan.templates.values()) + list(new_templates)
    caps = dict(plan.caps)
    caps.update({t.name: int(new_caps[t.name]) for t in new_templates})
    extended = compile_plan(plan.catalog, merged, caps,
                            max_results=plan.max_results,
                            union_cap=plan.union_cap,
                            group_union_cap=plan.group_union_cap)
    _check_plan_prefix(plan, extended)
    return extended


def _check_plan_prefix(old: CompiledPlan, new: CompiledPlan) -> None:
    """Prefix stability at the PLAN level (the IR level is re-checked by
    ``lowering.check_extension_prefix`` after the extended plan
    lowers)."""
    raise_on(lint_plan_prefix(old, new))


def migrate_carry(old: LoweredPlan, new: LoweredPlan, carry,
                  rid_carry) -> Tuple[Optional[dict], Optional[dict]]:
    """Remap the executor's carries from ``old``'s layout into ``new``'s.

    Returns ``(carry', rid_carry')``; either half is ``None`` when it
    must be RE-SEEDED instead (the forced full-rescan beat regenerates
    both, so ``None`` is always safe).

    * scan words — zero-padded on the high (appended-slot) side into
      each surviving stage's new window, on the device; a table that
      gains its FIRST predicated column has no words to extend -> reseed.
    * key partitions — pass through when the fold adds no join stages;
      otherwise -> reseed.
    * rid arrays — pass through per surviving join key; any new carried
      join has no rid history -> reseed the rid half.
    """
    check_extension_prefix(old, new)
    new_carry = None
    if carry is not None:
        scan, ok = {}, True
        old_scan = {s.table: s for s in old.scans if s.cols}
        for st in new.scans:
            if not st.cols:
                continue
            os_ = old_scan.get(st.table)
            if os_ is None or st.table not in carry["scan"]:
                ok = False      # newly predicated table: no words to pad
                break
            words = carry["scan"][st.table]
            pad = (st.whi - st.wlo) - (os_.whi - os_.wlo)
            scan[st.table] = F.pad(words, (0, pad)) if pad else words
        if ok and len(new.joins) == len(old.joins):
            new_carry = {"scan": scan, "parts": carry["parts"]}
    new_rids = None
    if rid_carry is not None:
        keys = [j.key for j in new.joins if j.kind != "gather"]
        if keys and all(k in rid_carry for k in keys):
            new_rids = {k: rid_carry[k] for k in keys}
    return new_carry, new_rids
