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

Admission and prefix stability are proven by the planlint passes
(``analysis_static.ir_passes``: ``lint_fold_batch``, ``lint_plan_prefix``,
``lint_extension_prefix``) — the same passes the lint CLI and the
mutation corpus exercise — and rejected with the offending rule id in
the ``FoldError`` message.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch.nn.functional as F

from repro_torch.analysis_static.diagnostics import raise_on_error
from repro_torch.analysis_static.ir_passes import (lint_fold_batch,
                                                   lint_plan_prefix)
from repro_torch.core.lowering import LoweredPlan, check_extension_prefix
from repro_torch.core.plan import CompiledPlan, QueryTemplate, compile_plan


class FoldError(ValueError):
    """A requested fold cannot preserve the running plan as a prefix."""


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
    raise_on_error(lint_fold_batch(plan, new_templates, new_caps),
                   exc=FoldError)
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
    """Prefix stability at the PLAN level, through the planlint pass (the
    IR level is re-checked by ``lowering.check_extension_prefix`` after
    the extended plan lowers)."""
    raise_on_error(lint_plan_prefix(old, new), exc=FoldError)


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
