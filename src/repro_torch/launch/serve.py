"""Serving launcher: SharedDB-cycle LM serving with batched requests, on
the CUDA card by default.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b

Every LM configuration serves: dense, MoE, recurrent (recurrentgemma),
SSD (mamba2), cross-attention (llama-vision: zero vision tokens) and
encoder-decoder (whisper: zero frames).  The decode step is captured as
a CUDA graph on the card, over a mesh too: ``--mesh single|multi``
serves over the production mesh (``launch/mesh.make_axes``), which needs
a process group of 256 (512) ranks and so raises on one card.
  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \\
      --smoke --device cpu --requests 8
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.launch.mesh import make_axes, make_production_mesh
from repro_torch.serving import CycleServer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--capacity", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--prefill-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--mesh", default="none",
                    choices=["none", "single", "multi"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    mesh = None if args.mesh == "none" else make_production_mesh(
        multi_pod=args.mesh == "multi")
    server = CycleServer(cfg, make_axes(mesh), capacity=args.capacity,
                         max_seq=args.max_seq, prefill_len=args.prefill_len,
                         seed=args.seed, device=args.device)

    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    for _ in range(args.requests):
        prompt = rng.integers(1, cfg.vocab, args.prefill_len).tolist()
        server.submit(prompt, max_new_tokens=args.new_tokens)
    done = server.run_until_drained()
    dt = time.time() - t0
    toks = sum(len(r.output) for r in done)
    lats = [r.done_time - r.arrival for r in done]
    ftl = [r.first_token_time - r.arrival for r in done]
    where = torch.cuda.get_device_name(server.device) \
        if server.device.type == "cuda" else str(server.device)
    print(f"arch={cfg.name} device={where} kernels={server.kernels} "
          f"requests={len(done)} cycles={server.cycles} tokens={toks}")
    print(f"throughput: {toks/dt:.1f} tok/s | {len(done)/dt:.2f} req/s")
    print(f"latency p50={np.percentile(lats,50)*1e3:.0f}ms "
          f"p99={np.percentile(lats,99)*1e3:.0f}ms | first-token "
          f"p50={np.percentile(ftl,50)*1e3:.0f}ms")
    assert all(len(r.output) == args.new_tokens for r in done)
    return done


if __name__ == "__main__":
    main()
