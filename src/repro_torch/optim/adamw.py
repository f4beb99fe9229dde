"""AdamW with float32 moments over bfloat16 parameters, global-norm
clipping and optional sign compression of gradients with error feedback:
``repro.optim.adamw`` term for term.

State is a tree shaped like the parameters: ``{"m": ..., "v": ...,
"step": int32 scalar}``.  Not ``torch.optim.AdamW``: that keeps bf16
moments for bf16 parameters and rounds in another order.  The update is
plain torch under ``torch.no_grad()``; it writes the new parameters,
moments and step into the given tensors (one copy of the training state
on the card, not two; the reference donates them to the same effect)
and returns trees of those tensors.

Over a mesh the leaves are DTensors: the moments sit on their
parameters' placements (``opt_state_specs``), each gradient is brought
to its parameter's placements before the update (a partial sum reduces
there), the update stays in place on each rank's shard, and
``_global_norm`` sums the squares over every shard of the mesh, so the
clip factor, and the clipped update, equal the unsharded ones.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core import pytree
from repro_torch.core.device import is_dtensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    compression: str = "none"   # none | sign (1-bit w/ error feedback)


def adamw_init(params):
    """Zero float32 moments shaped like ``params`` and an int32 step."""
    def zeros(p):
        if is_dtensor(p):      # on the parameter's placements
            return torch.zeros_like(p, dtype=torch.float32)
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    first = pytree.leaves(params)
    device = first[0].device if first else None
    step = torch.zeros((), dtype=torch.int32, device=device)
    if first and is_dtensor(first[0]):
        from torch.distributed.tensor import Replicate, distribute_tensor
        mesh = first[0].device_mesh
        step = distribute_tensor(step, mesh, [Replicate()] * mesh.ndim)
    return {"m": pytree.tree_map(zeros, params),
            "v": pytree.tree_map(zeros, params),
            "step": step}



def opt_state_specs(param_specs):
    """Moments shard exactly like their parameters; the step is
    replicated."""
    return {"m": param_specs, "v": param_specs, "step": ()}


def _global_norm(tree):
    """sqrt of the float32 sum of squares over every leaf, the leaves
    added in the reference's order."""
    sq = sum(torch.sum(torch.square(x.float())) for x in pytree.leaves(tree))
    return torch.sqrt(sq)


@torch.no_grad()
def compress_grads(grads, state, cfg: AdamWConfig):
    """1-bit sign compression with error feedback (arXiv:1802.04434 style).

    Returns (the decompressed gradients as seen after the all-reduce, the
    new state with the error ``err``); the wire format is the runtime's
    concern."""
    if cfg.compression == "none":
        return grads, state
    err = state.get("err")
    if err is None:
        err = pytree.tree_map(
            lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                  device=g.device), grads)
    corrected = pytree.tree_map(lambda g, e: g.float() + e, grads, err)
    scale = pytree.tree_map(lambda c: torch.mean(torch.abs(c)), corrected)
    quant = pytree.tree_map(lambda c, s: torch.sign(c) * s, corrected, scale)
    new_err = pytree.tree_map(lambda c, q: c - q, corrected, quant)
    state = dict(state)
    state["err"] = new_err
    return quant, state


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig,
                 lr: Optional[Any] = None):
    """One AdamW step, in place -> (params, state, gnorm).

    Gradients clipped to a global norm of ``cfg.grad_clip`` and taken in
    float32; bias-corrected moments; ``p - lr * (mh / (sqrt(vh) + eps) +
    wd * p)`` in float32, cast back to ``p.dtype``.  ``lr``: a float or a
    float32 tensor (a schedule's), default ``cfg.lr``."""
    lr = cfg.lr if lr is None else lr
    gnorm = _global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)

    step = state["step"] + 1
    bc1 = 1.0 - cfg.b1 ** step.float()
    bc2 = 1.0 - cfg.b2 ** step.float()

    for p, g, m, v in zip(pytree.leaves(params), pytree.leaves(grads),
                          pytree.leaves(state["m"]),
                          pytree.leaves(state["v"])):
        if is_dtensor(p):
            g = g.redistribute(p.device_mesh, p.placements)
        g = g.float() * clip
        new_m = cfg.b1 * m + (1 - cfg.b1) * g
        new_v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mh = new_m / bc1
        vh = new_v / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps) \
            + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
        m.copy_(new_m)
        v.copy_(new_v)
    state["step"].copy_(step)
    return params, state, gnorm
