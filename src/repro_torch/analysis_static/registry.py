"""The planlint rule + pass registry.

Rules are declared once, here, with the JAX package's ids and families
(``repro.analysis_static.registry``), so the CLI can print the full
table, the README rule table has one source of truth, and a finding
names the same rule in both packages.  Pass modules register their
entry points with ``register_pass`` at import time.

Three rules are declared without a pass in this package yet:
``jaxpr-delta-collective``, ``jaxpr-reseed-collective`` and
``fold-mirror-set`` need the sharded engine (the port runs on one
device).  The kernel rules hold the port's own fused_delta descriptor
(``kernels/fused_delta.py::launch_schedule``), and ``jaxpr-delta-width``
/ ``jaxpr-donated-alias`` read what a beat records when it runs
(``trace_passes``): their summaries say what each proves here.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

FAMILIES = ("ir", "fold", "jaxpr", "kernel", "source")


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    family: str
    summary: str


RULES: Dict[str, Rule] = {}


def _rule(id: str, family: str, summary: str) -> str:
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}")
    RULES[id] = Rule(id, family, summary)
    return id


# ---- IR rules (always-on: engine construction + every fold build) -----
IR_SLOT_OVERLAP = _rule(
    "ir-slot-overlap", "ir",
    "template admission slot ranges must be pairwise disjoint")
IR_SLOT_COVERAGE = _rule(
    "ir-slot-coverage", "ir",
    "slot ranges must have positive caps and fit inside qcap "
    "(a multiple of 32)")
IR_WORD_WINDOW = _rule(
    "ir-word-window", "ir",
    "per-stage word windows, subscriber masks and predicate scatter "
    "plans must stay in bounds")
IR_PARTITION_GEOMETRY = _rule(
    "ir-partition-geometry", "ir",
    "partition-bucket geometry must cover the table capacity and the "
    "construction-time measured key skew (bucket_cap >= max_dup)")

# ---- fold rules (begin_fold / extend_plan admission) ------------------
FOLD_DUPLICATE_TEMPLATE = _rule(
    "fold-duplicate-template", "fold",
    "a fold may not register a template name already in the plan")
FOLD_DUPLICATE_IN_BATCH = _rule(
    "fold-duplicate-in-batch", "fold",
    "template names within one fold batch must be distinct")
FOLD_ZERO_CAP = _rule(
    "fold-zero-cap", "fold",
    "every folded template needs a positive slot capacity")
FOLD_ALIEN_TABLE = _rule(
    "fold-alien-table", "fold",
    "folds admit new query shapes, not new tables: every referenced "
    "table must already be in the catalog")
FOLD_UNKNOWN_COLUMN = _rule(
    "fold-unknown-column", "fold",
    "folded template predicates must bind existing columns")
FOLD_PLAN_PREFIX = _rule(
    "fold-plan-prefix", "fold",
    "the extended plan must keep every existing slot range and node "
    "position (plan-level prefix stability)")
FOLD_PREFIX_STABILITY = _rule(
    "fold-prefix-stability", "fold",
    "the extended LOWERED plan must be a prefix-stable extension "
    "(windows widen high-side only, stage order and join access paths "
    "fixed) or carries cannot migrate")
FOLD_IN_FLIGHT = _rule(
    "fold-in-flight", "fold",
    "only one fold may be in flight per engine")
FOLD_MIRROR_SET = _rule(
    "fold-mirror-set", "fold",
    "a fold under a mesh must not change the mirrored table set")

# ---- beat rules (the reference reads jaxprs; the port records the
# ---- ops a beat runs) -------------------------------------------------
JAXPR_DELTA_COLLECTIVE = _rule(
    "jaxpr-delta-collective", "jaxpr",
    "delta beats must contain ZERO collective primitives at every "
    "shard count (shard-local by construction)")
JAXPR_RESEED_COLLECTIVE = _rule(
    "jaxpr-reseed-collective", "jaxpr",
    "the full/reseed beat's only collective is one all_gather per "
    "mirrored predicated scan stage, over that stage's per-shard rows")
JAXPR_DELTA_WIDTH = _rule(
    "jaxpr-delta-width", "jaxpr",
    "no full-window compare/probe may be reachable on the delta path "
    "(steady state pays pane width, never window width)")
JAXPR_DONATED_ALIAS = _rule(
    "jaxpr-donated-alias", "jaxpr",
    "fixed beat buffers (every slot's results, the carry, every slot's "
    "staging) occupy disjoint storage, a body never writes the rid "
    "carry it reads, and it writes in place exactly the donated "
    "arguments (DONATION_SPEC)")

# ---- kernel rules (the fused_delta launch descriptor) -----------------
KERNEL_SCHEDULE_COVERAGE = _rule(
    "kernel-schedule-coverage", "kernel",
    "the launch descriptor is the schedule reordered plus COPY tiles: "
    "every pane tile / dirty slot / probe slot / rid tile is owned by "
    "exactly one descriptor row")
KERNEL_GATHER_BOUNDS = _rule(
    "kernel-gather-bounds", "kernel",
    "every row, rid tile and bucket an item reads stays inside its "
    "extent")
KERNEL_GRID_LENGTH = _rule(
    "kernel-grid-length", "kernel",
    "the block-item prefix is exactly the pane tiles, the grid is "
    "grid_blocks' within sm_count x BLOCKS_PER_SM, and the descriptor "
    "fits the kernel's compiled bounds")
KERNEL_GARBAGE_PARK = _rule(
    "kernel-garbage-park", "kernel",
    "every scan-word row of a pane tile and every rid has exactly one "
    "writer: a live dirty row's PROBE, else one COPY tile")

# ---- source rules -----------------------------------------------------
NO_BARE_ASSERT = _rule(
    "no-bare-assert", "source",
    "hot-path modules guard with raises, never bare assert "
    "(stripped under python -O)")


@dataclasses.dataclass(frozen=True)
class LintPass:
    name: str
    family: str
    rules: Tuple[str, ...]
    fn: Callable
    summary: str


PASSES: Dict[str, LintPass] = {}


def register_pass(name: str, family: str, rules: Tuple[str, ...],
                  summary: str):
    """Decorator: register a pass entry point under the registry."""
    def deco(fn):
        for r in rules:
            if r not in RULES:
                raise ValueError(f"pass {name!r} names unknown rule {r!r}")
        PASSES[name] = LintPass(name, family, tuple(rules), fn, summary)
        return fn
    return deco


def all_rules() -> List[Rule]:
    return [RULES[k] for k in sorted(RULES)]
