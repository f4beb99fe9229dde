"""The correctness check's readings on the card: for each seed, one run
of the cell at its own load, judged twice in one pass by the same checks
and limits, the program's answers and, in their place, the control's, a
reference that answers each beat's queries from the state before that
beat's writes (it breaks the guarantee that a query sees every write
admitted up to and including its own beat).  All seeds run in one
process.

    python3 bench/control.py --workload <cell> --seeds 1,2,3 --seconds 51

Prints one line a seed: the program's checks and the control's.  Exits
with 1 unless every program run is correct and every control run is
not.  The benchmark's own runs never run the control.
"""
import json
import sys
import time

from run import ROOT  # noqa: F401  (puts the repository on sys.path)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 3
    from bench import harness
    ok = True
    for seed in (int(s) for s in args.seeds.split(",")):
        r = harness.run_cell(args.workload, seed, args.seconds, False,
                             time.perf_counter(), control=True,
                             out=lambda line: None)
        c = r["control"]
        print(json.dumps({
            "seed": seed, "attempted": r["attempted"],
            "correct": r["correct"],
            "program": {k: x["value"] for k, x in r["checks"].items()},
            "control_correct": c["correct"],
            "control": {k: x["value"] for k, x in c["checks"].items()}}),
            flush=True)
        ok &= r["correct"] and not c["correct"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
