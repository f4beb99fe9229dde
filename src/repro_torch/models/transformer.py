"""The dense decoder-only language model of the port: layer programs,
init, prefill and one decode step (``repro.models.transformer``'s dense
serving half).

A model compiles to a *layer program*: a group of sublayers repeated
``n_groups`` times plus optional leftover sublayers.

  dense GQA           group = [attn]                          x L
  gemma3 (5:1)        group = [attn(w)]*5 + [attn(0)]         x 10  + 2 local
  mixtral (MoE, SWA)  group = [attn(w, moe)]                  x L
  qwen2-moe           group = [attn(moe)]                     x L

Parameters are plain nested dicts in the JAX package's layout: the
group's sublayer ``idx`` lives under ``g{idx}`` with every leaf stacked,
the layer axis first; leftover sublayer ``idx`` under ``x{idx}``; then
``embed``, ``unembed`` (untied only) and ``final_norm``.  Caches follow
the same keys: ``k/v [n_groups, B, W, KV, D]`` and ``pos [n_groups, B,
W]`` (-1 = empty slot) for group entries, the same without the layer axis
for leftovers.  The group is a Python loop over layers (PyTorch runs
eagerly; there is no scan and no remat).

A ``moe`` sublayer's MLP is the sort-dispatch MoE block
(``models/moe.py``); its load-balance loss is discarded in prefill and
decode, as the reference discards it.  The ``ssm``, ``rec``
(recurrent), ``cross`` and encoder-decoder programs are not ported yet:
``build_program`` raises for them (ROADMAP §1 item 12).  Training
(``loss_fn``) comes with the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import (ParamStore, apply_norm, apply_rope,
                                       block_attention, decode_attention,
                                       rope_tables)


# ---------------------------------------------------------------------------
# Layer programs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str               # attn (cross | rec | ssm: not ported yet)
    window: int = 0         # 0 = full attention
    causal: bool = True
    moe: bool = False
    has_mlp: bool = True


@dataclasses.dataclass(frozen=True)
class Program:
    n_groups: int
    group: Tuple[LayerSpec, ...]
    leftover: Tuple[LayerSpec, ...] = ()

    @property
    def n_layers(self) -> int:
        return self.n_groups * len(self.group) + len(self.leftover)


def build_program(cfg: ArchConfig) -> Program:
    """The attention programs, dense and MoE; raises NotImplementedError
    for the programs the port does not have yet."""
    kind = ("enc-dec" if cfg.enc_dec else "ssm" if cfg.family == "ssm"
            else "rec" if cfg.rglru_pattern else "cross" if cfg.cross_every
            else None)
    if kind is not None:
        raise NotImplementedError(
            f"{cfg.name}: the {kind} layer program is not ported to "
            f"repro_torch yet (ROADMAP.md §1 item 12)")
    loc, glob = cfg.local_global
    is_moe = cfg.moe is not None
    if loc > 0 and glob > 0:
        group = tuple([LayerSpec("attn", window=cfg.window, moe=is_moe)] * loc
                      + [LayerSpec("attn", window=0, moe=is_moe)] * glob)
        per = loc + glob
        n = cfg.n_layers // per
        rest = cfg.n_layers - n * per
        leftover = tuple([LayerSpec("attn", window=cfg.window,
                                    moe=is_moe)] * rest)
        return Program(n, group, leftover)
    return Program(cfg.n_layers,
                   (LayerSpec("attn", window=cfg.window, moe=is_moe),))


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_norm(store: ParamStore, name: str, d: int, kind: str):
    sub = store.subtree(name)
    # layernorm's scale is drawn at random (1/sqrt(d)), not zeroed
    sub.add("scale", (d,), zeros=(kind == "rmsnorm"))
    if kind != "rmsnorm":
        sub.add("bias", (d,), zeros=True)


def _init_attn(store: ParamStore, cfg: ArchConfig):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    store.add("wq", (d, cfg.n_heads, hd))
    store.add("wk", (d, cfg.n_kv, hd))
    store.add("wv", (d, cfg.n_kv, hd))
    store.add("wo", (cfg.n_heads, hd, d))
    if cfg.qkv_bias:
        store.add("bq", (cfg.n_heads, hd), zeros=True)
        store.add("bk", (cfg.n_kv, hd), zeros=True)
        store.add("bv", (cfg.n_kv, hd), zeros=True)


def _init_sublayer(store: ParamStore, spec: LayerSpec, cfg: ArchConfig):
    _init_norm(store, "norm", cfg.d_model, cfg.norm)
    _init_attn(store.subtree("attn"), cfg)
    if spec.has_mlp:
        _init_norm(store, "mlp_norm", cfg.d_model, cfg.norm)
        mstore = store.subtree("mlp")
        if spec.moe:
            moe_lib.init_moe(mstore, cfg.d_model, cfg.moe)
        elif cfg.act in ("swiglu", "gelu_glu"):
            moe_lib.init_mlp(mstore, cfg.d_model, cfg.d_ff)
        else:
            moe_lib.init_mlp_nonglu(mstore, cfg.d_model, cfg.d_ff)


def init_lm(generator: torch.Generator, cfg: ArchConfig, device,
            dtype=torch.bfloat16) -> dict:
    """Random parameters on ``device`` from ``generator``, with the
    reference's shapes, distributions and scales (not its bits)."""
    store = ParamStore(generator, device, dtype)
    Vp = cfg.vocab_padded()
    store.add("embed", (Vp, cfg.d_model), scale=0.02)
    if not cfg.tie_embeddings:
        store.add("unembed", (cfg.d_model, Vp), scale=0.02)
    _init_norm(store, "final_norm", cfg.d_model, cfg.norm)
    prog = build_program(cfg)
    if prog.n_groups:
        for idx, spec in enumerate(prog.group):
            sub = ParamStore(generator, device, dtype, stack=prog.n_groups)
            _init_sublayer(sub, spec, cfg)
            store.params[f"g{idx}"] = sub.params
    for idx, spec in enumerate(prog.leftover):
        _init_sublayer(store.subtree(f"x{idx}"), spec, cfg)
    return store.params


def layer_params(tree, layer: int):
    """One layer's view of a stacked (group) parameter or cache tree."""
    if isinstance(tree, dict):
        return {k: layer_params(v, layer) for k, v in tree.items()}
    return tree[layer]


# ---------------------------------------------------------------------------
# Sublayer application
# ---------------------------------------------------------------------------


def _qkv(p, x, cfg):
    """-> q [B,S,H,hd], k, v [B,S,KV,hd]."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def _attn_full(p, x, spec: LayerSpec, cfg, positions, kernels):
    """Prefill attention.  Returns (out, (k, v)); k, v for the cache."""
    q, k, v = _qkv(p, x, cfg)
    sin, cos = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    out = block_attention(q, k, v, causal=spec.causal, window=spec.window,
                          kernels=kernels)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), (k, v)


def _attn_decode(p, x, spec: LayerSpec, cfg, cache, positions):
    """Single-token attention; writes the new K/V into the ring-buffer
    cache IN PLACE (slot = position % W) and returns (out, cache)."""
    q, k_new, v_new = _qkv(p, x, cfg)
    sin, cos = rope_tables(positions[:, None], cfg.resolved_head_dim,
                           cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k_new = apply_rope(k_new, sin, cos)
    W = cache["k"].shape[1]
    slot = (positions % W).long()
    bidx = torch.arange(x.shape[0], device=x.device)
    cache["k"][bidx, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][bidx, slot] = v_new[:, 0].to(cache["v"].dtype)
    cache["pos"][bidx, slot] = positions.to(cache["pos"].dtype)
    out = decode_attention(q, cache["k"], cache["v"], cache["pos"],
                           positions, window=spec.window)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), cache


def _apply_mlp_part(p, spec: LayerSpec, x, cfg):
    """The MLP half of a sublayer on the residual ``x``: (x + mlp, aux),
    aux the MoE load-balance loss (0.0 for a dense MLP)."""
    if not spec.has_mlp:
        return x, 0.0
    h = apply_norm(x, p["mlp_norm"], cfg.norm)
    if spec.moe:
        y, aux = moe_lib.apply_moe(p["mlp"], h, cfg.moe, cfg.act,
                                   dispatch=cfg.moe_dispatch)
    elif cfg.act in ("swiglu", "gelu_glu"):
        y, aux = moe_lib.apply_mlp(p["mlp"], h, cfg.act), 0.0
    else:
        y, aux = moe_lib.apply_mlp_nonglu(p["mlp"], h, cfg.act), 0.0
    return x + y, aux


def _pack_kv_cache(k, v, spec: LayerSpec, capacity: int):
    """Arrange prefill K/V into the ring-buffer layout (slot = pos % W)."""
    B, S = k.shape[:2]
    W = min(capacity, spec.window) if spec.window else capacity
    dev = k.device
    if S >= W:
        slots = torch.arange(S - W, S, device=dev) % W
        k_c = torch.zeros((B, W) + k.shape[2:], dtype=k.dtype, device=dev)
        v_c = torch.zeros((B, W) + v.shape[2:], dtype=v.dtype, device=dev)
        pos_c = torch.full((B, W), -1, dtype=torch.int32, device=dev)
        k_c[:, slots] = k[:, S - W:]
        v_c[:, slots] = v[:, S - W:]
        pos_c[:, slots] = torch.arange(S - W, S, dtype=torch.int32,
                                       device=dev)
    else:
        pad = W - S
        k_c = torch.cat([k, k.new_zeros((B, pad) + k.shape[2:])], dim=1)
        v_c = torch.cat([v, v.new_zeros((B, pad) + v.shape[2:])], dim=1)
        pos_c = torch.cat(
            [torch.arange(S, dtype=torch.int32, device=dev).expand(B, S),
             torch.full((B, pad), -1, dtype=torch.int32, device=dev)], dim=1)
    return {"k": k_c, "v": v_c, "pos": pos_c}


def _sublayer_attn(p, spec: LayerSpec, x, cfg, positions,
                   cache_capacity: int, kernels: str):
    """The attention half of a prefill sublayer.  Returns (the residual
    after it, its cache entry)."""
    h = apply_norm(x, p["norm"], cfg.norm)
    y, (k, v) = _attn_full(p["attn"], h, spec, cfg, positions, kernels)
    return x + y, _pack_kv_cache(k, v, spec, cache_capacity)


def _sublayer_train(p, spec: LayerSpec, x, cfg, positions,
                    cache_capacity: int, kernels: str):
    """One prefill sublayer.  Returns (x, its cache entry); a MoE
    block's aux loss is discarded."""
    x, entry = _sublayer_attn(p, spec, x, cfg, positions, cache_capacity,
                              kernels)
    x, _ = _apply_mlp_part(p, spec, x, cfg)
    return x, entry


def _sublayer_decode(p, spec: LayerSpec, x, cfg, positions, cache):
    h = apply_norm(x, p["norm"], cfg.norm)
    y, cache = _attn_decode(p["attn"], h, spec, cfg, cache, positions)
    x, _ = _apply_mlp_part(p, spec, x + y, cfg)
    return x, cache


# ---------------------------------------------------------------------------
# Whole-model passes
# ---------------------------------------------------------------------------


def _run_program(params, prog: Program, x, cfg, positions, *,
                 cache_capacity: int, kernels: str):
    """Every prefill layer in order.  Returns (x, caches dict)."""
    caches = {}
    if "g0" in params:          # n_groups may be 0 (depth-probe configs)
        entries = {f"g{idx}": [] for idx in range(len(prog.group))}
        for layer in range(prog.n_groups):
            for idx, spec in enumerate(prog.group):
                key = f"g{idx}"
                x, entry = _sublayer_train(
                    layer_params(params[key], layer), spec, x, cfg,
                    positions, cache_capacity, kernels)
                entries[key].append(entry)
        for key, per_layer in entries.items():
            caches[key] = {f: torch.stack([e[f] for e in per_layer])
                           for f in ("k", "v", "pos")}
    for idx, spec in enumerate(prog.leftover):
        x, caches[f"x{idx}"] = _sublayer_train(
            params[f"x{idx}"], spec, x, cfg, positions, cache_capacity,
            kernels)
    return x, caches


def _embed(params, tokens):
    return params["embed"][tokens.long()]


def _unembed(params, cfg, x):
    x = apply_norm(x, params["final_norm"], cfg.norm)
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return torch.einsum("bsd,dv->bsv", x, w)


def prefill(params, batch, cfg: ArchConfig,
            cache_capacity: Optional[int] = None, last_pos=None, *,
            kernels: str = "hopper"):
    """Run the prompt; returns (logits [B, Vp] at ``last_pos``, cache).

    ``last_pos`` (an int, default S - 1) selects which position's logits
    to return: a server right-pads short prompts to one prefill length,
    and under causal attention a dense model's true last prompt position's
    hidden state equals an unpadded prefill's (not a MoE model's: the pads
    compete with the prompt for expert capacity, as in the reference).
    The cache's K/V keep the activations' dtype.  ``kernels`` picks the
    attention: "hopper" (the kernel; its plain version on CPU tensors) or
    "torch"."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    cap = cache_capacity or S
    prog = build_program(cfg)
    x = _embed(params, tokens)
    positions = torch.arange(S, device=tokens.device)[None]
    x, caches = _run_program(params, prog, x, cfg, positions,
                             cache_capacity=cap, kernels=kernels)
    last = S - 1 if last_pos is None else int(last_pos)
    logits = _unembed(params, cfg, x[:, last:last + 1])
    return logits[:, 0], caches


# ---------------------------------------------------------------------------
# Decode cache
# ---------------------------------------------------------------------------


def cache_struct(cfg: ArchConfig, batch: int, capacity: int) -> dict:
    """The decode cache's layout: {key: {field: (shape, dtype)}}, K/V in
    bfloat16 whatever the parameters' dtype.

    ``capacity``: KV slots of full-attention layers (window layers keep
    min(window, capacity))."""
    prog = build_program(cfg)
    hd = cfg.resolved_head_dim

    def entry(spec: LayerSpec, stacked: int):
        lead = (stacked,) if stacked else ()
        W = min(spec.window, capacity) if spec.window else capacity
        return {"k": (lead + (batch, W, cfg.n_kv, hd), torch.bfloat16),
                "v": (lead + (batch, W, cfg.n_kv, hd), torch.bfloat16),
                "pos": (lead + (batch, W), torch.int32)}

    shapes = {}
    if prog.n_groups > 0:
        for idx, spec in enumerate(prog.group):
            shapes[f"g{idx}"] = entry(spec, prog.n_groups)
    for idx, spec in enumerate(prog.leftover):
        shapes[f"x{idx}"] = entry(spec, 0)
    return shapes


def init_cache(cfg: ArchConfig, batch: int, capacity: int, device) -> dict:
    """Zero decode cache on ``device`` (pos slots -1 = empty), laid out
    as ``cache_struct``."""
    def mk(shape, dt):
        if dt == torch.int32:
            return torch.full(shape, -1, dtype=dt, device=device)
        return torch.zeros(shape, dtype=dt, device=device)
    return {key: {f: mk(*sd) for f, sd in entry.items()}
            for key, entry in cache_struct(cfg, batch, capacity).items()}


def decode_step(params, caches, tokens, positions, cfg: ArchConfig):
    """One token for every sequence: tokens [B,1], positions [B] ->
    (logits [B, Vp], caches).  The new K/V are written into ``caches``
    IN PLACE (the reference donates its cache to the same effect); the
    returned dict is ``caches`` itself."""
    prog = build_program(cfg)
    x = _embed(params, tokens)
    for layer in range(prog.n_groups if "g0" in params else 0):
        for idx, spec in enumerate(prog.group):
            key = f"g{idx}"
            x, _ = _sublayer_decode(layer_params(params[key], layer), spec,
                                    x, cfg, positions,
                                    layer_params(caches[key], layer))
    for idx, spec in enumerate(prog.leftover):
        key = f"x{idx}"
        x, _ = _sublayer_decode(params[key], spec, x, cfg, positions,
                                caches[key])
    logits = _unembed(params, cfg, x)
    return logits[:, 0], caches
