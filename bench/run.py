"""Run one benchmark cell once on the CUDA card and print its result.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is the result object; the lines before
it are the set-up's parts and what the run saw.  The last lines of
standard error are the correctness checks, each number beside its limit.
Without a CUDA card (or with fewer than the cell's chips) it exits with
code 3 and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# build and kernel caches at fixed paths inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench import harness
    spec = harness.load_spec()
    cell = harness.find_cell(spec, args.workload)
    import torch
    print(f"setup python_and_torch_import_s "
          f"{time.perf_counter() - T_START:.6f}")
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: the cell needs {chips} CUDA device(s), this machine "
              f"has {n}", file=sys.stderr)
        return 3
    t = time.perf_counter()
    torch.cuda.init()
    torch.cuda.synchronize()
    print(f"setup card_init_s {time.perf_counter() - t:.6f}")
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), T_START)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
