"""Query-at-a-time baseline engine (the paper's MySQL / "SystemX" role).

One query runs one small plan of its own (per template, like a prepared
statement): predicate-pushdown scan -> bounded candidate extraction ->
per-query join lookups -> per-query sort -> limit.  Work grows LINEARLY
with the number of queries.  It shares no operator with the shared
engine's hot path (no bitmasks, no backend ops), which makes it the
independent oracle the shared engine's tickets are compared with.
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.executor import Ticket
from repro_torch.core.operators import topk_stable
from repro_torch.core.plan import CompiledPlan, QueryTemplate
from repro_torch.core.storage import (UpdateSlots, apply_updates,
                                      empty_update_batch, locate_rows_by_key,
                                      nonzero_static, tree_to_torch)

INT_MAX = 2147483647


class QueryAtATimeEngine:
    def __init__(self, plan: CompiledPlan,
                 initial_data: Dict[str, Dict[str, np.ndarray]],
                 candidate_cap=4096, device=None):
        """candidate_cap: the candidate rows a query extracts from its
        spine; a template whose spine has no pushdown-able predicate takes
        the full spine capacity for exact results.  ``device`` as for
        SharedDBEngine."""
        self.plan = plan
        self.candidate_cap = candidate_cap
        self.device = resolve_device(device)
        self.state = plan.catalog.init_state(initial_data, self.device)
        self._fns = {name: self._build(tpl)
                     for name, tpl in plan.templates.items()}

    def _cap_for(self, tpl: QueryTemplate) -> int:
        spine_cap = self.plan.catalog.schemas[tpl.spine].capacity
        if not any(p.table == tpl.spine for p in tpl.preds):
            return spine_cap  # exactness requires the full spine
        return min(self.candidate_cap, spine_cap)

    def _build(self, tpl: QueryTemplate):
        plan = self.plan
        K = self._cap_for(tpl)
        schema = plan.catalog.schemas[tpl.spine]

        def fn(storage, params):
            """params: int32[n_preds, 2].  One query at a time."""
            spine = storage[tpl.spine]
            ok = spine["_valid"]
            for pi, p in enumerate(tpl.preds):
                if p.table == tpl.spine:
                    col = spine[p.col]
                    ok = ok & (col >= params[pi, 0]) & (col <= params[pi, 1])
            cand = nonzero_static(ok, K, schema.capacity)
            live = cand < schema.capacity
            cand_safe = cand.clamp(max=schema.capacity - 1)

            for j in tpl.joins:
                fk = spine[j.fk_col][cand_safe]
                pk_tbl = storage[j.pk_table]
                pk_schema = plan.catalog.schemas[j.pk_table]
                if pk_schema.indexed:
                    idx = pk_tbl["_pk_index"]
                    rid = torch.where((fk >= 0) & (fk < idx.shape[0]),
                                      idx[fk.long().clamp(0,
                                                          idx.shape[0] - 1)],
                                      -1)
                else:
                    rid = locate_rows_by_key(pk_tbl[pk_schema.pk], fk,
                                             pk_tbl["_valid"])
                rid_safe = rid.long().clamp(0, pk_tbl["_valid"].shape[0] - 1)
                live = live & (rid >= 0) & pk_tbl["_valid"][rid_safe]
                for pi, p in enumerate(tpl.preds):
                    if p.table == j.pk_table:
                        col = pk_tbl[p.col][rid_safe]
                        live = live & (col >= params[pi, 0]) \
                            & (col <= params[pi, 1])

            if tpl.group is not None:
                g = tpl.group
                codes = spine[g.group_col][cand_safe].long()
                vals = spine[g.agg_col][cand_safe].to(torch.float32)
                w = live.to(torch.float32)
                count = w.new_zeros(g.n_groups).index_add_(0, codes, w)
                ssum = w.new_zeros(g.n_groups).index_add_(0, codes, w * vals)
                score = ssum if g.order_by == "sum" else count
                top_val, top_grp = topk_stable(score, g.top_k)
                return {"groups": top_grp.to(torch.int32),
                        "scores": top_val, "counts": count[top_grp]}

            if tpl.sort_col:
                key = spine[tpl.sort_col][cand_safe]
                key = torch.where(live, -key if tpl.sort_desc else key,
                                  INT_MAX)
            else:
                key = torch.where(live, cand, INT_MAX)
            order = torch.sort(key, stable=True).indices
            rows = torch.where(live[order], cand[order], -1)
            n = min(plan.max_results, K)
            lim = min(tpl.limit, plan.max_results)
            out = torch.full((plan.max_results,), -1, dtype=torch.int32,
                             device=rows.device)
            out[:n] = torch.where(torch.arange(n, device=rows.device) < lim,
                                  rows[:n], -1).to(torch.int32)
            return {"rows": out}

        return fn

    def execute(self, template: str, params: Dict) -> Ticket:
        """Run one query's prepared plan and return its ticket."""
        tpl = self.plan.templates[template]
        arr = np.zeros((max(len(tpl.preds), 1), 2), np.int32)
        for pi in range(len(tpl.preds)):
            arr[pi] = params[pi]
        t = Ticket(0, template, params, time.perf_counter())
        res = self._fns[template](self.state,
                                  torch.as_tensor(arr, device=self.device))
        t.result = {k: v.cpu().numpy() for k, v in res.items()}
        t.done_time = time.perf_counter()
        return t

    def apply_update(self, table: str, kind: str, payload: Dict) -> None:
        """Single-statement update (auto-commit), applied immediately."""
        schema = self.plan.catalog.schemas[table]
        b = empty_update_batch(schema, UpdateSlots(1, 1, 1), xp=np)
        if kind == "insert":
            for c, v in payload.items():
                b["ins_rows"][c][0] = int(v)
            b["ins_mask"][0] = True
        elif kind == "update":
            b["upd_key"][0] = int(payload["key"])
            b["upd_col"][0] = schema.columns.index(payload["col"])
            b["upd_val"][0] = int(payload["val"])
            b["upd_mask"][0] = True
        else:
            b["del_key"][0] = int(payload["key"])
            b["del_mask"][0] = True
        self.state = dict(self.state)
        self.state[table] = apply_updates(
            schema, self.state[table], tree_to_torch(b, self.device))
