"""Training launcher, on the CUDA card by default.

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
      --seq 4096 --batch 2 --steps 8

CPU-scale usage (smoke config, real steps):
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
      --smoke --device cpu --steps 30 --batch 8 --seq 64 --ckpt /tmp/ckpt

The reference's flags, plus ``--device``.  ``--mesh single|multi`` trains
over the production mesh (``launch/mesh.make_axes``: parameters,
optimizer state and batches as DTensors placed by the model's specs),
which needs a process group of 256 (512) ranks and so raises on one
card, as the reference does on fewer devices.  bf16 parameters from the
port's seeded init, float32 AdamW moments, the plain attention
(``transformer.loss_fn``), the synthetic pipeline's batches with float32
cast to bf16; with ``--ckpt`` the ``FaultTolerantLoop`` checkpoints every
``--save-every`` steps and a second run resumes from the newest
checkpoint, on a mesh too: each leaf is stored whole and restored onto
the model's placements (``checkpoint/``), so a run may resume on another
mesh, or unsharded.  ``Trainer(args, axes)`` trains on a given mesh (an
elastic rung's, ``runtime/elastic.shrink_and_resume``).

A training run uses deterministic algorithms (``deterministic``), so
that a run replayed from a checkpoint is bit-identical to the first.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time

# cuBLAS keeps a fixed workspace, as deterministic algorithms require,
# only when this is set before CUDA initialises
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402
import torch.utils.deterministic  # noqa: E402

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.core import pytree  # noqa: E402
from repro_torch.core.device import resolve_device  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.launch.mesh import make_axes, make_production_mesh  # noqa: E402,E501
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.runtime import FaultTolerantLoop  # noqa: E402


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--save-every", type=int, default=10)
    ap.add_argument("--mesh", default="none",
                    choices=["none", "single", "multi"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms for the duration (the previous settings
    restored after).  Warn-only: the card's float ``cumsum`` (the SSD
    layers' segment sums) has no alternative and warns; it scans each row
    of a multi-dimensional tensor without atomics, and a replayed run is
    held bit-equal to the first (``chip_smoke.py``).  New tensors are not
    filled (the mode's default fills every allocation; no op here reads
    memory it did not write)."""
    det = torch.utils.deterministic
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    fill = det.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        det.fill_uninitialized_memory = fill
        torch.use_deterministic_algorithms(was, warn_only=warn)


class Trainer:
    """The model, optimizer and data of one training run from ``args``
    (``parse_args``); ``step_fn`` is the ``FaultTolerantLoop``'s step.
    ``axes``: the mesh to train on in place of ``--mesh``'s (an elastic
    rung's, ``runtime/elastic.shrink_and_resume``); ``cfg``: the model
    in place of ``--arch``'s (a depth cut of it)."""

    def __init__(self, args: argparse.Namespace, axes=None, cfg=None):
        self.args = args
        if cfg is None:
            cfg = smoke_config(args.arch) if args.smoke \
                else get_config(args.arch)
        if axes is None:
            axes = make_axes(None if args.mesh == "none" else
                             make_production_mesh(   # raises without ranks
                                 multi_pod=args.mesh == "multi"))
        self.cfg = cfg
        self.device = resolve_device(args.device)
        self.api = get_model(cfg, axes, device=self.device,
                             kernels="torch",
                             opt_cfg=AdamWConfig(lr=args.lr))
        self.pipe = TokenPipeline(DataConfig(
            vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
            seed=args.seed,
            frames_dim=cfg.d_model if cfg.enc_dec else 0,
            frames_len=args.seq * cfg.dec_ratio if cfg.enc_dec else 0,
            vision_tokens=cfg.n_vision_tokens if cfg.cross_every else 0,
            vision_dim=cfg.d_model if cfg.cross_every else 0))

    def init_state(self):
        """(bf16 parameters from ``--seed``, their AdamW state)."""
        params = self.api.init_params(self.args.seed)
        return params, self.api.init_opt(params)

    def batch(self, step: int) -> dict:
        """The pipeline's batch of ``step`` on the device: float32 cast
        to bf16, integers kept."""
        batch = {k: torch.from_numpy(v).to(
                     self.device, torch.bfloat16 if v.dtype.name == "float32"
                     else None)
                 for k, v in self.pipe.batch_at(step).items()}
        axes = self.api.axes
        b = axes.batch(self.args.batch)
        return {k: axes.distribute(v, b) for k, v in batch.items()}

    def step_fn(self, state, step: int):
        params, opt = state
        loss, params, opt, gnorm = self.api.train_step(params, opt,
                                                       self.batch(step))
        return (params, opt), {"step": step, "loss": float(loss),
                               "gnorm": float(gnorm)}


def run(trainer: Trainer, *, fail_at=None):
    """The launcher's flow on ``trainer``: with ``--ckpt`` the
    checkpointed ``FaultTolerantLoop``, resuming from the newest
    checkpoint restored into the model's analytic template (re-sharded
    onto ``--mesh``'s placements; nothing initialised first), else init
    and plain steps.  ``fail_at``: {step: exception} injected into the
    loop (needs ``--ckpt``).  Returns (state, metrics log)."""
    args = trainer.args
    if fail_at and not args.ckpt:
        raise ValueError("fault injection needs --ckpt")
    ckpt = CheckpointManager(args.ckpt) if args.ckpt else None
    start = (ckpt.latest_step() or 0) if ckpt else 0
    if start:
        state, _ = ckpt.restore(trainer.api.state_template(), start)
    else:
        state = trainer.init_state()
    n_params = sum(p.numel() for p in pytree.leaves(state[0]))
    where = torch.cuda.get_device_name(trainer.device) \
        if trainer.device.type == "cuda" else str(trainer.device)
    print(f"arch={trainer.cfg.name} params={n_params/1e6:.2f}M "
          f"mesh={args.mesh} device={where}", flush=True)
    t0 = time.time()
    with deterministic():
        if ckpt:
            loop = FaultTolerantLoop(trainer.step_fn, ckpt,
                                     save_every=args.save_every)
            if start:
                print(f"resumed from step {start}", flush=True)
            state, log = loop.run(state, start, args.steps - start,
                                  fail_at=fail_at)
        else:
            log = []
            for s in range(args.steps):
                state, m = trainer.step_fn(state, s)
                log.append(m)
    for m in log:
        if m["step"] % max(1, args.steps // 10) == 0 \
                or m["step"] == args.steps - 1:
            print(f"step {m['step']:5d} loss {m['loss']:.4f} "
                  f"gnorm {m['gnorm']:.3f}", flush=True)
    dt = time.time() - t0
    if log:
        first, last = log[0]["loss"], log[-1]["loss"]
        print(f"done: loss {first:.4f} -> {last:.4f} "
              f"({args.steps} steps, {dt:.1f}s)", flush=True)
    trainer.pipe.stop()
    return state, log


def main(argv=None, *, fail_at=None):
    """Train as the command line says; returns the metrics log."""
    return run(Trainer(parse_args(argv)), fail_at=fail_at)[1]


if __name__ == "__main__":
    main()
