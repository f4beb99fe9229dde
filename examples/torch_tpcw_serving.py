"""End-to-end driver on the PyTorch/CUDA port: the full TPC-W workload
served by SharedDB on the card.

Replays a stream of web interactions from the shopping mix against the
shared engine AND the query-at-a-time baseline, printing the throughput /
latency comparison (the in-miniature version of the paper's Fig. 7).

    PYTHONPATH=src python examples/torch_tpcw_serving.py [n] [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.core.baseline import QueryAtATimeEngine
from repro_torch.core.executor import SharedDBEngine
from repro_torch.workloads import tpcw

ap = argparse.ArgumentParser()
ap.add_argument("n", type=int, nargs="?", default=150,
                help="web interactions")
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA card)")
args = ap.parse_args()
n = args.n
rng = np.random.default_rng(1)
SCALE_I, SCALE_C = 1000, 2880

plan = tpcw.build_tpcw_plan(SCALE_I, SCALE_C)
data = tpcw.generate_data(rng, SCALE_I, SCALE_C)
shared = SharedDBEngine(plan, tpcw.DEFAULT_UPDATE_SLOTS, data,
                        device=args.device)
qaat = QueryAtATimeEngine(plan, data, device=args.device)
gen = tpcw.WorkloadGenerator(rng, SCALE_I, SCALE_C)

inters = gen.sample_mix("shopping", n)
n_q = sum(len(it.queries) for it in inters)
n_u = sum(len(it.updates) for it in inters)
print(f"{n} shopping-mix interactions = {n_q} queries + {n_u} updates "
      f"on {shared.device}")

# ---- SharedDB: everything batched through the always-on plan -----------
t0 = time.time()
for it in inters:
    for q in it.queries:
        shared.submit(*q)
    for u in it.updates:
        shared.submit_update(*u)
shared.run_until_drained()
t_shared = time.time() - t0
print(f"SharedDB : {n / t_shared:7.1f} WIPS  "
      f"({shared.cycles_run} cycles, "
      f"{t_shared / max(shared.cycles_run, 1) * 1e3:.0f} ms/cycle)")

# ---- query-at-a-time baseline ------------------------------------------
inters2 = gen.sample_mix("shopping", n)
t0 = time.time()
for it in inters2:
    for u in it.updates:
        qaat.apply_update(*u)
    for q in it.queries:
        qaat.execute(*q)
t_base = time.time() - t0
print(f"QueryAtAT: {n / t_base:7.1f} WIPS")
print(f"shared-vs-qaat wall ratio at n={n}: {t_base / t_shared:.2f}x "
      f"(grows with concurrency)")
