"""Sweep one traffic parameter of a cell on the card, all points in one
process (each point builds a fresh engine and runs the cell's set-up,
warm-up and window), to find the rate a cell's traffic file fixes.

    python3 bench/sweep.py --workload <cell> --seed <n> --seconds <s> \
        --key rate_per_s --values 3200,4000,4800

Prints, for each value, the run's window lines and one summary line:
the interactions due and completed in time a second, the latency
percentiles, the failures and the backlog at each quarter of the window.
Not a measured run: nothing here sets a bound.
"""
import json
import sys
import time

from run import ROOT  # noqa: F401  (puts the repository on sys.path)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--key", required=True)
    ap.add_argument("--values", required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 3
    from bench import harness
    for k, v in enumerate(args.values.split(",")):
        value = float(v)
        lines = []
        r = harness.run_cell(args.workload, args.seed + k, args.seconds,
                             False, time.perf_counter(),
                             overrides={f"traffic.{args.key}": value},
                             out=lines.append)
        for line in lines:
            if line.startswith("window"):
                print(f"  {args.key}={value}: {line}")
        m = {n: x["value"] for n, x in r["metrics"].items()}
        print(json.dumps({"sweep": args.key, "value": value,
                          "attempted": r["attempted"], "failed": r["failed"],
                          "correct": r["correct"], "metrics": m}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
