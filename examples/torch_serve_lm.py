"""Serve a reduced-config LM on the PyTorch/CUDA port with SharedDB
heartbeat cycles: batched admission, one always-on compiled plan (the
decode step a CUDA graph on the card), bounded per-cycle work.

    PYTHONPATH=src python examples/torch_serve_lm.py [arch] [--device cpu]
"""
import argparse

from repro_torch.launch import serve

ap = argparse.ArgumentParser()
ap.add_argument("arch", nargs="?", default="recurrentgemma-2b")
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA card)")
args = ap.parse_args()
serve.main(["--arch", args.arch, "--smoke", "--requests", "24",
            "--capacity", "8", "--max-seq", "96", "--prefill-len", "24",
            "--new-tokens", "12"]
           + (["--device", args.device] if args.device else []))
