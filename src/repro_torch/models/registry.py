"""Model registry of the port: one API over the language models (dense,
MoE, recurrent, SSD, cross-attention and encoder-decoder).

``get_model(cfg)`` returns a :class:`ModelApi`:

  init_params(seed)                         -> params (nested dict)
  prefill(params, batch, cache_capacity,
          last_pos)                         -> (last_logits, cache)
  decode_step(params, cache, tokens, pos)   -> (logits, cache)
  init_cache(batch, capacity, ctx_len)      -> cache
  ctx_len(seq_len) / dec_len(seq_len)       -> context / decoder length
  loss(params, batch)                       -> float32 scalar
  init_opt(params)                          -> AdamW state
  train_step(params, opt, batch)            -> (loss, params, opt, gnorm)

``params_from_numpy`` carries the JAX package's parameter tree across.
The dry-run's analytic specs (``param_specs``, ``opt_specs``,
``input_specs``, ``input_pspecs``, ``step_fn``: PartitionSpecs for the
reference's ``launch/dryrun.py``) are not ported, as that tool is not.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import ArchConfig
from repro_torch.core import pytree
from repro_torch.core.backends import resolve_backend
from repro_torch.core.device import resolve_device
from repro_torch.models import transformer
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update


def resolve_kernels(kernels: str, device) -> str:
    """"hopper" (the flash-attention kernel) or "torch" (its plain
    version) for a ``kernels=`` spec; "auto" follows the operator
    backends: hopper on a CUDA card of capability 9.0+, torch on the
    CPU, and ``device=None`` is the card (raises without one)."""
    if kernels in ("hopper", "torch"):
        return kernels
    if kernels != "auto":
        raise ValueError(f"kernels must be 'hopper', 'torch' or 'auto', "
                         f"got {kernels!r}")
    return resolve_backend("auto", device).name


@dataclasses.dataclass
class ModelApi:
    cfg: ArchConfig
    device: torch.device
    kernels: str = "hopper"       # prefill attention: "hopper" | "torch"
    opt_cfg: AdamWConfig = AdamWConfig()

    def init_params(self, seed: int = 0) -> dict:
        """Random bfloat16 parameters on the model's device from ``seed``
        (float32 ones come from ``params_from_numpy``)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return transformer.init_lm(gen, self.cfg, self.device)

    def prefill(self, params, batch, cache_capacity: Optional[int] = None,
                last_pos=None):
        return transformer.prefill(params, batch, self.cfg, cache_capacity,
                                   last_pos=last_pos, kernels=self.kernels)

    def decode_step(self, params, caches, tokens, positions):
        return transformer.decode_step(params, caches, tokens, positions,
                                       self.cfg)

    def init_cache(self, batch: int, capacity: int,
                   ctx_len: int = 0) -> dict:
        return transformer.init_cache(self.cfg, batch, capacity,
                                      self.device, ctx_len)

    def loss(self, params, batch):
        """The training loss (``transformer.loss_fn``: plain attention
        whatever ``kernels`` says)."""
        return transformer.loss_fn(params, batch, self.cfg)

    def init_opt(self, params):
        return adamw_init(params)

    def train_step(self, params, opt_state, batch):
        """One AdamW step on ``batch`` -> (loss, params, opt_state,
        gnorm).  The gradients come from ``torch.autograd.grad`` over the
        parameter leaves, in their dtype (bf16 over bf16 parameters, as
        ``jax.value_and_grad`` gives); the update writes the new
        parameters and moments into ``params`` and ``opt_state`` in place
        (the reference donates both to the same effect) and returns
        them."""
        leaves = pytree.leaves(params)
        with torch.enable_grad():
            live = [p.detach().requires_grad_() for p in leaves]
            loss = self.loss(pytree.unflatten(params, live), batch)
            grads = torch.autograd.grad(loss, live)
        params, opt_state, gnorm = adamw_update(
            params, pytree.unflatten(params, grads), opt_state,
            self.opt_cfg)
        return loss.detach(), params, opt_state, gnorm

    def ctx_len(self, seq_len: int) -> int:
        """The cross sublayers' context length for a step of
        ``seq_len``: the encoder's frames (enc-dec), the vision tokens
        (cross), else 0."""
        if self.cfg.enc_dec:
            return seq_len
        if self.cfg.cross_every:
            return self.cfg.n_vision_tokens
        return 0

    def dec_len(self, seq_len: int) -> int:
        """The decoder's length for a step of ``seq_len`` (an enc-dec
        model decodes ``dec_ratio`` times fewer tokens than it hears)."""
        if self.cfg.enc_dec:
            return max(self.cfg.conv_kernel, seq_len // self.cfg.dec_ratio)
        return seq_len


def get_model(cfg: ArchConfig, *, device=None, kernels: str = "auto",
              opt_cfg: AdamWConfig = AdamWConfig()) -> ModelApi:
    """The model API on ``device`` (None: the CUDA card)."""
    device = resolve_device(device)
    return ModelApi(cfg=cfg, device=device,
                    kernels=resolve_kernels(kernels, device),
                    opt_cfg=opt_cfg)


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: exact via float32
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.tensor(a, device=device)


def params_from_numpy(tree, cfg: ArchConfig, device=None) -> dict:
    """The JAX package's parameter tree, as numpy arrays (stacked ``g*``
    leaves with the layer axis first, ``x*`` leftovers, ``embed``,
    ``unembed`` when untied, ``final_norm``), as the port's parameters on
    ``device`` (None: the CUDA card), dtypes kept.

    Raises ValueError unless the tree has exactly the keys and shapes
    ``init_lm`` makes for ``cfg``."""
    device = resolve_device(device)
    want = transformer.init_lm(None, cfg, "meta", torch.float32)

    def convert(node, spec, path):
        if isinstance(spec, dict):
            if not isinstance(node, dict) or set(node) != set(spec):
                got = sorted(node) if isinstance(node, dict) else type(node)
                raise ValueError(f"params_from_numpy: {path or 'root'} has "
                                 f"{got}, want {sorted(spec)}")
            return {k: convert(node[k], spec[k], f"{path}/{k}")
                    for k in spec}
        t = _to_tensor(node, device)
        if tuple(t.shape) != tuple(spec.shape):
            raise ValueError(f"params_from_numpy: {path} has shape "
                             f"{tuple(t.shape)}, want {tuple(spec.shape)}")
        return t

    return convert(tree, want, "")
