"""planlint CLI: prove heartbeat invariants before the first beat.

    python -m repro_torch.analysis_static.lint --device cpu   # CPU sweep
    python -m repro_torch.analysis_static.lint                # on the card
    python -m repro_torch.analysis_static.lint --rules        # rule table
    python -m repro_torch.analysis_static.lint --backends torch,hopper
    python -m repro_torch.analysis_static.lint --device cpu --shards 1,2,4

Sweeps workload plans x operator backends on one device and runs every
pass family against the REAL lowered plan, the REAL engine built from it
(its construction gate included) and the fused_delta descriptor that
``launch_schedule`` builds on the device: the IR passes, the kernel
passes, and the trace passes over one recorded body of each cycle
flavour (on the ``torch`` backend, whatever the engine's: a hand-written
kernel's body is opaque to the recorder).  ``hopper`` needs the card.
``--shards N`` (N > 0) adds sharded cells: the engine runs on a row mesh
of ``--device`` repeated N times, the kernel passes hold one shard's
fused_delta geometry, and the trace passes add the collective rules
(``jaxpr-delta-collective``, ``jaxpr-reseed-collective``) on the
recorded bodies.  Like every entry point of the port it runs on the CUDA
card unless ``--device cpu`` asks for the CPU.  Exit status 1 iff any
error-severity finding survives.
"""
from __future__ import annotations

import argparse
import sys
from typing import List

import numpy as np

from repro_torch.analysis_static.diagnostics import (LintFinding, errors_in,
                                                     format_findings)
from repro_torch.analysis_static import ir_passes, kernel_passes
from repro_torch.analysis_static import source_passes, trace_passes
from repro_torch.analysis_static.registry import PASSES, all_rules

WORKLOADS = ("tpcw", "tpcw-nopk")
# streaming multiprocessors the kernel grid is checked against when the
# sweep runs on the CPU: an H100 SXM's
H100_SMS = 132


def _build_plan(workload: str, scale_i: int, scale_c: int):
    from repro_torch.workloads import tpcw
    if workload not in WORKLOADS:
        raise ValueError(f"unknown workload {workload!r}; one of "
                         f"{WORKLOADS}")
    plan = tpcw.build_tpcw_plan(
        scale_i, scale_c, dense_pk_index=(workload == "tpcw"))
    data = tpcw.generate_data(np.random.default_rng(0), scale_i, scale_c)
    return plan, data


def lint_config(workload: str, backend_name: str, n_shards: int,
                scale_i: int, scale_c: int, device=None
                ) -> List[LintFinding]:
    """All pass families against one (workload, backend, shards) cell
    (``n_shards`` 0: the single-device engine)."""
    from repro_torch import kernels as K
    from repro_torch.core import sharding
    from repro_torch.core.device import resolve_device
    from repro_torch.core.executor import SharedDBEngine, _measure_key_stats
    from repro_torch.core.lowering import lower_plan
    from repro_torch.workloads import tpcw

    if n_shards < 0:
        raise ValueError(f"--shards {n_shards}: a shard count is >= 0")
    dev = resolve_device(device)
    if backend_name == "hopper" and dev.type != "cuda":
        raise ValueError("backend 'hopper' needs the CUDA card; on the CPU "
                         "its wrappers run the plain versions")
    cfg = f"{workload}/{backend_name}" + \
        (f"/shards={n_shards}" if n_shards else "")
    plan, data = _build_plan(workload, scale_i, scale_c)
    key_stats = _measure_key_stats(plan, data)
    lowered = lower_plan(plan, key_stats=key_stats)

    # ---- IR family (the always-on bundle, here surfaced as findings)
    findings = (ir_passes.lint_slot_layout(plan)
                + ir_passes.lint_word_windows(lowered)
                + ir_passes.lint_partition_geometry(lowered, key_stats))
    if errors_in(findings):
        return findings         # the engine's construction gate refuses it

    mesh = spec = None
    if n_shards:
        mesh = sharding.make_row_mesh(n_shards, [dev] * n_shards)
        spec = sharding.build_shard_spec(plan, mesh)

    # ---- kernel family: the descriptor launch_schedule builds (and
    # caches) on the device, for one shard's fused call under a mesh
    geom = kernel_passes.geometry_from_lowered(lowered) if spec is None \
        else sharding.fused_geometry(lowered, spec)
    if geom.sgeom or geom.jgeom:
        desc, n_block = kernel_passes.launch_descriptor(geom, dev)
        sms = K.sm_count(dev) if dev.type == "cuda" else H100_SMS
        findings += kernel_passes.run_kernel_passes(
            geom, desc, n_block, sms=sms, location=cfg)

    # ---- the engine (construction gate included) and its beats
    eng = SharedDBEngine(plan, tpcw.DEFAULT_UPDATE_SLOTS, data,
                         kernels=backend_name, device=dev, jit=False,
                         mesh=mesh)
    findings += trace_passes.run_trace_passes(eng, location=cfg)
    return findings


def _print_rules() -> None:
    print(f"{'rule id':<26} {'family':<7} summary")
    for r in all_rules():
        print(f"{r.id:<26} {r.family:<7} {r.summary}")
    print(f"\n{len(all_rules())} rules across "
          f"{len(PASSES)} registered passes")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis_static.lint",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workloads", default=",".join(WORKLOADS),
                    help="comma list from: " + ", ".join(WORKLOADS))
    ap.add_argument("--backends", default="torch",
                    help="comma list from: torch, hopper (the card only)")
    ap.add_argument("--shards", default="0",
                    help="comma list of shard counts; 0 = unsharded, N > 0 "
                         "= a row mesh of --device repeated N times")
    ap.add_argument("--scale-items", type=int, default=64)
    ap.add_argument("--scale-customers", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--rules", action="store_true",
                    help="print the rule table and exit")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="also print warning/info findings")
    args = ap.parse_args(argv)
    if args.rules:
        _print_rules()
        return 0

    all_findings: List[LintFinding] = source_passes.lint_hot_path_asserts()
    configs = [(w, b, int(s))
               for w in args.workloads.split(",")
               for b in args.backends.split(",")
               for s in args.shards.split(",")]
    for w, b, s in configs:
        findings = lint_config(w, b, s, args.scale_items,
                               args.scale_customers, args.device)
        errs = errors_in(findings)
        rest = [f for f in findings if f.severity != "error"]
        tag = "FAIL" if errs else "ok"
        cell = f"{w}/{b}" + (f"/shards={s}" if s else "")
        print(f"[{tag:>4}] {cell} — {len(errs)} error(s), "
              f"{len(rest)} note(s)")
        all_findings += findings

    errs = errors_in(all_findings)
    shown = all_findings if args.verbose else errs
    if shown:
        print()
        print(format_findings(shown))
    print(f"\nplanlint: {len(configs)} configs, "
          f"{len(errs)} error finding(s)")
    return 1 if errs else 0


if __name__ == "__main__":
    sys.exit(main())
