"""Bounded-computation model + SLA provisioning (paper §3.5), on the
H100's own figures (``repro.core.sla``'s port).

SharedDB's key property: per-cycle work is a STATIC function of table
capacities and the query-slot capacity — never of the number of submitted
queries.  This module derives the worst-case cycle cost analytically from a
compiled plan and answers the paper's provisioning question: "if the SLA
says 3 seconds, provision so a worst-case cycle takes <= 1.5 s" (a query
waits at most one cycle and executes in the next).  The formulas are the
reference's, term for term; only the default hardware differs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

from repro_torch.core.plan import CompiledPlan
from repro_torch.roofline.analysis import HW, int32_ops_per_s


@dataclasses.dataclass(frozen=True)
class HwModel:
    # per card: the cycle's work is int32 compares, masks and gathers on
    # the CUDA cores, so its "flops" run at the int32 rate
    # (roofline.analysis.int32_ops_per_s: the card's own, else the H100
    # SXM's 16.73e12), not at the tensor cores' bf16 peak
    flops_per_s: float = dataclasses.field(default_factory=int32_ops_per_s)
    bytes_per_s: float = HW["hbm_bw"]     # HBM3, 3.35e12
    sort_const: float = 8.0               # comparisons per element per log2


def cycle_cost(plan: CompiledPlan, hw: HwModel = None) -> Dict:
    """Worst-case per-cycle flops/bytes per plan node (single card)."""
    hw = HwModel() if hw is None else hw
    Q = plan.qcap
    W = Q // 32
    nodes = {}
    total_flops = total_bytes = 0.0
    for table, node in plan.scans.items():
        T = plan.catalog.schemas[table].capacity
        C = max(len(node.cols), 1)
        f = 4.0 * T * Q * C + 2.0 * T * Q          # compares + pack
        b = 4.0 * T * C + 4.0 * T * W
        nodes[f"scan:{table}"] = {"flops": f, "bytes": b}
        total_flops += f
        total_bytes += b
    for j in plan.joins:
        T = plan.catalog.schemas[j.spine].capacity
        f = 2.0 * T * W
        b = T * (8.0 + 8.0 * W)                    # fk+rid gather + masks
        nodes[f"join:{j.spine}->{j.pk_table}"] = {"flops": f, "bytes": b}
        total_flops += f
        total_bytes += b
    for s in plan.sorts:
        T = plan.catalog.schemas[s.spine].capacity
        f = hw.sort_const * T * max(math.log2(T), 1.0)
        b = 8.0 * T * (1 + W)
        nodes[f"sort:{s.spine}.{s.col}"] = {"flops": f, "bytes": b}
        total_flops += f
        total_bytes += b
    for g in plan.groups:
        T = plan.catalog.schemas[g.spine].capacity
        # the reference's tiled contraction count (its matrix unit takes
        # 1024-wide tiles), kept for parity; the segment-sum floor below
        # binds whenever a group-by has fewer than 1024 groups
        f = 4.0 * T * g.agg.n_groups * Q / 1024
        f = max(f, 4.0 * T * Q)                    # segment-sum floor
        b = 4.0 * T * (1 + W) + 8.0 * g.agg.n_groups * Q
        nodes[f"group:{g.spine}.{g.agg.group_col}"] = {"flops": f,
                                                       "bytes": b}
        total_flops += f
        total_bytes += b
    t_flops = total_flops / hw.flops_per_s
    t_bytes = total_bytes / hw.bytes_per_s
    return {"nodes": nodes, "total_flops": total_flops,
            "total_bytes": total_bytes,
            "worst_cycle_s": max(t_flops, t_bytes)}


def provision(plan: CompiledPlan, sla_seconds: float,
              hw: HwModel = None) -> Dict:
    """Cards needed so worst-case latency (2 cycles) meets the SLA,
    assuming operator replication / partitioning scales linearly (§4.5)."""
    cost = cycle_cost(plan, hw)
    budget = sla_seconds / 2.0
    chips = max(1, math.ceil(cost["worst_cycle_s"] / budget))
    return {"worst_cycle_s": cost["worst_cycle_s"],
            "cycle_budget_s": budget,
            "chips_required": chips,
            "guarantee": f"p100 latency <= {sla_seconds}s at ANY "
                         f"concurrency <= {plan.qcap} queries/cycle"}
