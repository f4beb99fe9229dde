"""Global query plan (paper §3.2-3.3, Fig. 2/3/6).

The whole workload — a set of parameterized query *templates* (the JDBC
PreparedStatements of the paper) — compiles ONCE into a single dataflow
plan shared by every concurrent query:

  1. per query template, predicates are pushed down to base tables
     (logical optimization, Fig. 3 middle);
  2. templates are merged: ONE shared scan node per base table, ONE shared
     join node per (spine, fk, pk) signature, ONE shared sort node per
     (spine, column, direction), ONE shared group-by node per
     (spine, group-col, agg-col) — sharing across templates AND across
     concurrent instances of the same template falls out automatically;
  3. each template is assigned a static slot range in the global query-id
     space; per-node subscriber bitmasks select which queries a node's
     output applies to (queries become data).

The compiled plan is then LOWERED to an explicit staged operator graph
(lowering.py) whose hot loops resolve through the operator-backend
registry (backends.py: plain torch ops or the hand-written Hopper
kernels), and the resulting cycle function executes once per heartbeat
(executor.py): the paper's always-on plan.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import operators as ops
from repro_torch.core.storage import Catalog

INT_MIN = ops.INT_MIN
INT_MAX = ops.INT_MAX


# ---------------------------------------------------------------------------
# Template language
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Pred:
    table: str
    col: str               # parameterized inclusive range [lo, hi]


@dataclasses.dataclass(frozen=True)
class Join:
    fk_col: str            # on the spine
    pk_table: str


@dataclasses.dataclass(frozen=True)
class GroupAgg:
    group_col: str         # spine-local dict-encoded column
    n_groups: int
    agg_col: str           # spine-local value column (summed)
    top_k: int
    order_by: str = "sum"  # "sum" | "count"


@dataclasses.dataclass(frozen=True)
class QueryTemplate:
    name: str
    spine: str
    preds: Tuple[Pred, ...] = ()
    joins: Tuple[Join, ...] = ()
    sort_col: Optional[str] = None     # spine-local
    sort_desc: bool = False
    limit: int = 16
    group: Optional[GroupAgg] = None

    def tables(self) -> Tuple[str, ...]:
        return (self.spine,) + tuple(j.pk_table for j in self.joins)


# ---------------------------------------------------------------------------
# Compiled plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ScanNode:
    table: str
    cols: Tuple[str, ...]                  # predicated columns
    # per (template, pred) -> (col index, param index): filled by compiler
    bindings: List[Tuple[str, int, int]]   # (template, col_idx, param_idx)
    referencing: List[str]                 # templates whose graph has table


@dataclasses.dataclass
class JoinNode:
    spine: str
    fk_col: str
    pk_table: str
    subscribers: List[str]


@dataclasses.dataclass
class SortNode:
    spine: str
    col: str
    desc: bool
    subscribers: List[str]


@dataclasses.dataclass
class GroupNode:
    spine: str
    agg: GroupAgg
    subscribers: List[str]


@dataclasses.dataclass
class CompiledPlan:
    catalog: Catalog
    templates: Dict[str, QueryTemplate]
    caps: Dict[str, int]                   # per-template slot capacity
    offsets: Dict[str, int]                # slot range start per template
    qcap: int                              # global query-id capacity
    scans: Dict[str, ScanNode]
    joins: List[JoinNode]
    sorts: List[SortNode]
    groups: List[GroupNode]
    max_results: int
    # bounded union-extraction capacities (paper §3.5: work is a static
    # function of these, independent of query count; overflow is counted)
    union_cap: int = 8192
    group_union_cap: int = 16384

    @property
    def n_params_max(self) -> int:
        """Packed admission depth: max predicate count over templates.

        The executor stages ONE [qcap, n_params_max, 2] parameter buffer
        per heartbeat; each template's slots use rows [0, len(preds))."""
        return max([len(t.preds) for t in self.templates.values()] + [1])

    def sub_mask(self, names: List[str]) -> np.ndarray:
        """uint32[W] subscriber word-mask for a set of templates."""
        bits = np.zeros(self.qcap, bool)
        for t in names:
            bits[self.offsets[t]:self.offsets[t] + self.caps[t]] = True
        W = self.qcap // 32
        out = np.zeros(W, np.uint32)
        for w in range(W):
            val = 0
            for b in range(32):
                if bits[w * 32 + b]:
                    val |= (1 << b)
            out[w] = val
        return out

    def word_range(self, names: List[str]) -> Tuple[int, int]:
        """Smallest [wlo, whi) word window covering these templates' slots.

        Templates are laid out spine-clustered (workload definition order),
        so per-node mask processing only touches its subscribers' words —
        the per-operator work no longer scales with the GLOBAL query
        capacity, only with the operator's own (paper §4.2: per-operator
        queues/capacity).
        """
        lo = min(self.offsets[t] for t in names)
        hi = max(self.offsets[t] + self.caps[t] for t in names)
        return lo // 32, -(-hi // 32)


def compile_plan(catalog: Catalog, templates: List[QueryTemplate],
                 caps: Dict[str, int], max_results: int = 64,
                 union_cap: int = 8192,
                 group_union_cap: int = 16384) -> CompiledPlan:
    offsets, off = {}, 0
    for t in templates:
        offsets[t.name] = off
        off += caps[t.name]
    qcap = -(-off // 32) * 32

    # --- scan nodes: one per table, union of predicated columns ----------
    scans: Dict[str, ScanNode] = {}
    for t in templates:
        for table in t.tables():
            node = scans.setdefault(
                table, ScanNode(table, (), [], []))
            if t.name not in node.referencing:
                node.referencing.append(t.name)
    for t in templates:
        for pi, p in enumerate(t.preds):
            node = scans[p.table]
            if p.col not in node.cols:
                node.cols = node.cols + (p.col,)
            node.bindings.append((t.name, node.cols.index(p.col), pi))

    # --- join nodes: dedupe by (spine, fk, pk) ----------------------------
    joins: Dict[Tuple[str, str, str], JoinNode] = {}
    for t in templates:
        for j in t.joins:
            key = (t.spine, j.fk_col, j.pk_table)
            node = joins.setdefault(
                key, JoinNode(t.spine, j.fk_col, j.pk_table, []))
            node.subscribers.append(t.name)

    # --- sort nodes: dedupe by (spine, col, desc) --------------------------
    sorts: Dict[Tuple[str, str, bool], SortNode] = {}
    for t in templates:
        if t.sort_col:
            key = (t.spine, t.sort_col, t.sort_desc)
            node = sorts.setdefault(
                key, SortNode(t.spine, t.sort_col, t.sort_desc, []))
            node.subscribers.append(t.name)

    # --- group-by nodes ----------------------------------------------------
    groups: Dict[Tuple[str, str, str], GroupNode] = {}
    for t in templates:
        if t.group:
            key = (t.spine, t.group.group_col, t.group.agg_col)
            node = groups.setdefault(key, GroupNode(t.spine, t.group, []))
            node.subscribers.append(t.name)

    return CompiledPlan(
        catalog=catalog,
        templates={t.name: t for t in templates},
        caps=dict(caps), offsets=offsets, qcap=qcap,
        scans=scans, joins=list(joins.values()),
        sorts=list(sorts.values()), groups=list(groups.values()),
        max_results=max_results,
        union_cap=union_cap, group_union_cap=group_union_cap)


# The cycle functions themselves live in lowering.py: ``build_cycle``
# (full rescan, seeds the carried scan words) and ``build_delta_cycle``
# (the incremental heartbeat).  The executor lowers the plan once and
# binds both to one operator backend (backends.py: kernels="torch" |
# "hopper" | "auto").
