"""Quickstart on the PyTorch/CUDA port: the SharedDB engine in ~60 lines.

Builds a TPC-W database on the card, submits a mixed batch of concurrent
queries + updates, runs heartbeat cycles, and shows that one shared plan
answered everything — including per-query results and the
bounded-computation SLA model.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import sla
from repro_torch.core.executor import SharedDBEngine
from repro_torch.workloads import tpcw

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA card)")
args = ap.parse_args()

rng = np.random.default_rng(0)
SCALE = dict(scale_items=1000, scale_customers=2880)

plan = tpcw.build_tpcw_plan(**SCALE)
data = tpcw.generate_data(rng, **SCALE)
engine = SharedDBEngine(plan, tpcw.DEFAULT_UPDATE_SLOTS, data,
                        device=args.device)

print(f"Global plan (always-on, compiled once) on {engine.device}:")
print(f"  {len(plan.scans)} shared scans, {len(plan.joins)} shared joins, "
      f"{len(plan.sorts)} shared sorts, {len(plan.groups)} shared "
      f"group-bys; query capacity {plan.qcap}/cycle")

# one hundred concurrent queries of different types, one stone
tickets = []
for i in range(40):
    item = int(rng.integers(0, 1000))
    tickets.append(engine.submit("get_book", {0: (item, item)}))
for s in range(10):
    tickets.append(engine.submit("search_subject", {0: (s, s)}))
lo = 2000
tickets.append(engine.submit("best_sellers",
                             {0: (lo, 2**31 - 1), 1: (3, 3)}))
engine.submit_update("item", "update", {"key": 7, "col": "i_cost",
                                        "val": 999})

engine.run_until_drained()
print(f"\n{len(tickets)} queries answered in {engine.cycles_run} "
      f"heartbeat cycle(s)")

bk = tickets[0]
rows = bk.result["rows"]
item_row = engine.materialize("item", rows[rows >= 0][:1])
print(f"get_book -> item row {item_row['i_id'][0]}, "
      f"cost {item_row['i_cost'][0]} cents")
bs = tickets[-1]
print(f"best_sellers -> top-5 items {bs.result['groups'][:5].tolist()}, "
      f"qty {bs.result['scores'][:5].astype(int).tolist()}")

model = sla.provision(plan, sla_seconds=3.0)
print(f"\nSLA model: worst-case cycle {model['worst_cycle_s']*1e3:.2f} ms "
      f"per chip -> {model['chips_required']} chip(s) for a 3 s SLA")
print(model["guarantee"])
