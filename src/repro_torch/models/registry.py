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

Sharding: ``get_model(cfg, axes)`` takes the reference's ``MeshAxes``
(on a torch ``DeviceMesh``, ``models/common.py``).  The analytic specs
the dry-run (``launch/dryrun.py``) needs are the reference's:
``param_specs`` / ``opt_specs`` / ``input_pspecs`` (PartitionSpecs as
tuples), ``param_shapes`` / ``input_specs`` (``(shape, dtype)`` leaves,
nothing allocated) and ``step_fn(shape)``.  Under a mesh
``init_params``, ``params_from_numpy`` and ``init_cache`` place every
leaf on the mesh by its spec (DTensors), and the steps run on them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import ArchConfig, ShapeSpec
from repro_torch.core import pytree
from repro_torch.core.backends import resolve_backend
from repro_torch.core.device import one_draw, resolve_device
from repro_torch.models import transformer
from repro_torch.models.common import MeshAxes
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     opt_state_specs)


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
    axes: MeshAxes = MeshAxes()

    # ---------------- parameters -------------------------------------
    def init_params(self, seed: int = 0) -> dict:
        """Random bfloat16 parameters on the model's device from ``seed``
        (float32 ones come from ``params_from_numpy``); under a mesh the
        same values, each leaf placed by its spec (drawn once, whole, for
        every rank, simulated ranks too)."""
        with one_draw():
            gen = torch.Generator(device=self.device).manual_seed(seed)
            full = transformer.init_lm(gen, self.cfg, self.device)
        return self.place(full)

    def place(self, params) -> dict:
        """``params`` (full tensors) placed on the mesh by
        ``param_specs``; off-mesh ``params`` itself."""
        if self.axes.mesh is None:
            return params
        return pytree.dict_map(lambda t, s: self.axes.distribute(t, *s),
                               params, self.param_specs())

    def param_specs(self) -> dict:
        return transformer.lm_specs(self.cfg, self.axes)

    def param_shapes(self) -> dict:
        """{leaf: (shape, dtype)} of ``init_params``, nothing allocated."""
        meta = transformer.init_lm(None, self.cfg, "meta")
        return pytree.dict_map(lambda t: (tuple(t.shape), t.dtype), meta)

    def init_opt(self, params):
        return adamw_init(params)

    def opt_specs(self) -> dict:
        return opt_state_specs(self.param_specs())

    def state_template(self) -> tuple:
        """The analytic template of a training state ``(params, opt)``
        for ``checkpoint.load_pytree``: ``Placed`` leaves of
        ``param_shapes`` and of ``init_opt``'s float32 moments and int32
        step, on this model's device and, under a mesh, placed by
        ``param_specs`` / ``opt_specs``.  Nothing is allocated."""
        from repro_torch.checkpoint import Placed
        mesh = self.axes.mesh

        def leaf(shape, dtype, spec):
            pl = () if mesh is None else tuple(
                self.axes.placements(len(shape), *spec))
            return Placed(tuple(shape), dtype, self.device, mesh, pl)
        shapes, specs = self.param_shapes(), self.opt_specs()
        params = pytree.dict_map(lambda sd, sp: leaf(*sd, sp), shapes,
                                 specs["m"])

        def moments(sp):
            return pytree.dict_map(
                lambda sd, spec: leaf(sd[0], torch.float32, spec), shapes,
                sp)
        return params, {"m": moments(specs["m"]), "v": moments(specs["v"]),
                        "step": leaf((), torch.int32, specs["step"])}

    # ---------------- steps ------------------------------------------
    def prefill(self, params, batch, cache_capacity: Optional[int] = None,
                last_pos=None):
        return transformer.prefill(params, batch, self.cfg, cache_capacity,
                                   last_pos=last_pos, kernels=self.kernels,
                                   axes=self.axes)

    def decode_step(self, params, caches, tokens, positions):
        return transformer.decode_step(params, caches, tokens, positions,
                                       self.cfg, self.axes)

    def init_cache(self, batch: int, capacity: int,
                   ctx_len: int = 0) -> dict:
        return transformer.init_cache(self.cfg, batch, capacity,
                                      self.device, ctx_len, self.axes)

    def loss(self, params, batch):
        """The training loss (``transformer.loss_fn``: plain attention
        whatever ``kernels`` says)."""
        return transformer.loss_fn(params, batch, self.cfg, self.axes)

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
        # under a mesh the backward and the update meet plain constants
        # too (saved positions, masks): the scope covers them
        with self.axes.scope():
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

    # ---------------- analytic specs for the dry-run ------------------
    def input_specs(self, shape: ShapeSpec) -> dict:
        """{leaf: (shape, dtype)} of one step of ``shape``'s inputs (the
        reference's ShapeDtypeStructs; nothing allocated)."""
        cfg, B, S = self.cfg, shape.global_batch, shape.seq_len
        d = cfg.d_model

        def tok(s):
            return ((B, s), torch.int32)
        if shape.kind in ("train", "prefill"):
            Sd = self.dec_len(S)
            batch = {"tokens": tok(Sd)}
            if shape.kind == "train":
                batch["labels"] = tok(Sd)
            if cfg.enc_dec:
                batch["frames"] = ((B, S, d), torch.bfloat16)
            if cfg.cross_every:
                batch["vision"] = ((B, cfg.n_vision_tokens, d),
                                   torch.bfloat16)
            return {"batch": batch}
        # decode: one new token against a cache of seq_len
        cache = transformer.cache_struct(cfg, B, self.dec_len(S),
                                         ctx_len=self.ctx_len(S))
        return {"caches": cache, "tokens": tok(1),
                "positions": ((B,), torch.int32)}

    def input_pspecs(self, shape: ShapeSpec) -> dict:
        """PartitionSpecs (tuples) matching ``input_specs``."""
        cfg, B = self.cfg, shape.global_batch
        batch_ok = self.axes.mesh is None or B % self.axes.dp_size == 0
        b = self.axes.dp if batch_ok else None
        if shape.kind in ("train", "prefill"):
            batch = {"tokens": (b, None)}
            if shape.kind == "train":
                batch["labels"] = (b, None)
            if cfg.enc_dec:
                batch["frames"] = (b, None, None)
            if cfg.cross_every:
                batch["vision"] = (b, None, None)
            return {"batch": batch}
        return {"caches": transformer.cache_specs(cfg, B, self.axes),
                "tokens": (b, None), "positions": (b,)}

    def step_fn(self, shape: ShapeSpec):
        """The function the dry-run runs for this shape: the train step
        (backward and AdamW), the prefill at the decoder's length, or one
        decode step."""
        if shape.kind == "train":
            return self.train_step
        if shape.kind == "prefill":
            cap = self.dec_len(shape.seq_len)
            return lambda params, batch: self.prefill(
                params, batch, cache_capacity=cap)
        return self.decode_step


def get_model(cfg: ArchConfig, axes: MeshAxes = MeshAxes(), *, device=None,
              kernels: str = "auto",
              opt_cfg: AdamWConfig = AdamWConfig()) -> ModelApi:
    """The model API on ``device`` (None: the CUDA card).  Under a mesh
    (``axes.mesh``) its parameters, caches and inputs are DTensors on
    that mesh, whose device type must be ``device``'s."""
    device = resolve_device(device)
    mesh_type = getattr(axes.mesh, "device_type", device.type)
    if mesh_type != device.type:
        raise ValueError(f"get_model: mesh on {mesh_type}, device {device}")
    return ModelApi(cfg=cfg, device=device,
                    kernels=resolve_kernels(kernels, device),
                    opt_cfg=opt_cfg, axes=axes)


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: exact via float32
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.tensor(a, device=device)


def params_from_numpy(tree, cfg: ArchConfig, device=None,
                      axes: MeshAxes = MeshAxes()) -> dict:
    """The JAX package's parameter tree, as numpy arrays (stacked ``g*``
    leaves with the layer axis first, ``x*`` leftovers, ``embed``,
    ``unembed`` when untied, ``final_norm``), as the port's parameters on
    ``device`` (None: the CUDA card), dtypes kept; under a mesh each leaf
    placed by its spec.

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

    params = convert(tree, want, "")
    if axes.mesh is None:
        return params
    return pytree.dict_map(lambda t, s: axes.distribute(t, *s), params,
                           transformer.lm_specs(cfg, axes))
