"""The language models of the port: layer programs, init, prefill and
one decode step (``repro.models.transformer``'s serving half).

A model compiles to a *layer program*: a group of sublayers repeated
``n_groups`` times plus optional leftover sublayers.

  dense GQA           group = [attn]                          x L
  gemma3 (5:1)        group = [attn(w)]*5 + [attn(0)]         x 10  + 2 local
  mixtral (MoE, SWA)  group = [attn(w, moe)]                  x L
  qwen2-moe           group = [attn(moe)]                     x L
  llama-vision        group = [attn]*4 + [cross]              x 20
  recurrentgemma      group = [rec, rec, attn(w)]             x 8   + 2 rec
  mamba2              group = [ssm]                           x 48
  whisper             encoder program [attn(non-causal)] x 12 under the
                      ``enc_`` prefix + decoder [attn(no MLP), cross] x 12

Parameters are plain nested dicts in the JAX package's layout: the
group's sublayer ``idx`` lives under ``g{idx}`` with every leaf stacked,
the layer axis first; leftover sublayer ``idx`` under ``x{idx}``; then
``embed``, ``unembed`` (untied only) and ``final_norm``.  Caches follow
the same keys: an attention entry ``k/v [n_groups, B, W, KV, D]`` and
``pos [n_groups, B, W]`` (-1 = empty slot), a cross entry ``k/v
[n_groups, B, ctx_len, KV, D]`` (no ``pos``: every context position is
visible), a ``rec`` entry ``conv [n_groups, B, K-1, d]`` and ``h
[n_groups, B, d]``, an ``ssm`` entry ``conv [n_groups, B, K-1, conv_dim]``
and ``state [n_groups, B, heads, head_dim, state]``; the same without the
layer axis for leftovers.  The group is a Python loop over layers
(PyTorch runs eagerly; there is no scan); under ``cfg.remat == "full"``
the loss recomputes each group iteration in the backward pass
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint`` of
its scan body does.

A ``moe`` sublayer's MLP is the sort-dispatch MoE block
(``models/moe.py``); its load-balance loss, summed over the layers, joins
the training loss at weight 0.01 (``loss_fn``) and is discarded in
prefill and decode, as the reference discards it.  A cross sublayer
attends, without RoPE, causality or window, to a context: the encoder's
output of ``batch["frames"]`` (whisper) or ``batch["vision"]``
projected (llama-vision).  The recurrent (``models/rglru.py``) and SSD
(``models/ssm.py``) sublayers carry their state through prefill into the
cache, right-padding included, as the reference's do.

The training loss (``loss_fn``) runs the plain attention: the reference
trains through its plain ``block_attention``, and its flash kernel (like
the port's) has no backward.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs import ArchConfig
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru, ssm
from repro_torch.models.common import (ParamStore, apply_norm, apply_rope,
                                       block_attention, decode_attention,
                                       rope_tables)


# ---------------------------------------------------------------------------
# Layer programs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str               # attn | cross | rec | ssm
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
    """The decoder's layer program (whisper's: ``build_decoder_program``)."""
    if cfg.enc_dec:
        return build_decoder_program(cfg)
    if cfg.family == "ssm":
        return Program(cfg.n_layers, (LayerSpec("ssm", has_mlp=False),))
    if cfg.rglru_pattern:
        kinds = {"rec": LayerSpec("rec", window=0),
                 "attn": LayerSpec("attn", window=cfg.window)}
        group = tuple(kinds[k] for k in cfg.rglru_pattern)
        n = cfg.n_layers // len(group)
        rest = cfg.n_layers - n * len(group)
        leftover = tuple(kinds[k] for k in cfg.rglru_pattern[:rest])
        return Program(n, group, leftover)
    if cfg.cross_every:
        per = cfg.cross_every
        if cfg.n_layers % per:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers is not a "
                             f"whole number of groups of {per}")
        group = tuple([LayerSpec("attn", moe=cfg.moe is not None)]
                      * (per - 1) + [LayerSpec("cross")])
        return Program(cfg.n_layers // per, group)
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


def build_encoder_program(cfg: ArchConfig) -> Program:
    return Program(cfg.n_enc_layers, (LayerSpec("attn", causal=False),))


def build_decoder_program(cfg: ArchConfig) -> Program:
    """An encoder-decoder's decoder layer: self-attention (no MLP), then
    cross-attention with the MLP."""
    return Program(cfg.n_layers,
                   (LayerSpec("attn", has_mlp=False), LayerSpec("cross")))


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
    if spec.kind in ("attn", "cross"):
        _init_attn(store.subtree("attn"), cfg)
    elif spec.kind == "rec":
        rglru.init_rglru(store.subtree("rec"), cfg)
    elif spec.kind == "ssm":
        ssm.init_ssm(store.subtree("ssm"), cfg)
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
    _init_program(store, build_program(cfg), cfg, "")
    if cfg.enc_dec:
        store.add("w_frontend", (cfg.d_model, cfg.d_model))
        _init_norm(store, "enc_final_norm", cfg.d_model, cfg.norm)
        _init_program(store, build_encoder_program(cfg), cfg, "enc_")
    if cfg.cross_every:
        store.add("w_vision_proj", (cfg.d_model, cfg.d_model))
    return store.params


def _init_program(store: ParamStore, prog: Program, cfg: ArchConfig,
                  prefix: str):
    """The program's sublayers under ``{prefix}g{idx}`` (stacked) and
    ``{prefix}x{idx}``."""
    if prog.n_groups:
        for idx, spec in enumerate(prog.group):
            sub = ParamStore(store.generator, store.device, store.dtype,
                             stack=prog.n_groups)
            _init_sublayer(sub, spec, cfg)
            store.params[f"{prefix}g{idx}"] = sub.params
    for idx, spec in enumerate(prog.leftover):
        _init_sublayer(store.subtree(f"{prefix}x{idx}"), spec, cfg)


def layer_params(tree, layer: int):
    """One layer's view of a stacked (group) parameter or cache tree."""
    if isinstance(tree, dict):
        return {k: layer_params(v, layer) for k, v in tree.items()}
    return tree[layer]


# ---------------------------------------------------------------------------
# Sublayer application
# ---------------------------------------------------------------------------


def _qkv(p, x, cfg, ctx=None):
    """-> q [B,S,H,hd], k, v [B,Sk,KV,hd]: keys and values from ``ctx``
    (a cross sublayer) or from ``x``."""
    src = x if ctx is None else ctx
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", src, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", src, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def _attn_full(p, x, spec: LayerSpec, cfg, positions, kernels, ctx=None):
    """Prefill attention.  Returns (out, (k, v)); k, v for the cache.
    With a context (cross): no RoPE, not causal, no window."""
    q, k, v = _qkv(p, x, cfg, ctx)
    if ctx is None:
        sin, cos = rope_tables(positions, cfg.resolved_head_dim,
                               cfg.rope_theta)
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
    out = block_attention(q, k, v, causal=spec.causal and ctx is None,
                          window=spec.window if ctx is None else 0,
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


def _cross_decode(p, x, cfg, cache):
    """Decode-time cross-attention against the context's (k, v), all of
    it visible."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    k_c = cache["k"]
    pos = torch.zeros(x.shape[0], dtype=torch.int32, device=x.device)
    kv_pos = torch.zeros(k_c.shape[:2], dtype=torch.int32, device=x.device)
    out = decode_attention(q, k_c, cache["v"], kv_pos, pos)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


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


def _sublayer_attn(p, spec: LayerSpec, x, cfg, positions, ctx,
                   cache_capacity: int, kernels: str):
    """The token-mixing half of a prefill sublayer: attention, cross-
    attention (to ``ctx``), RG-LRU or SSD.  Returns (the residual after
    it, its cache entry; None when ``cache_capacity`` is 0, as for the
    encoder)."""
    h = apply_norm(x, p["norm"], cfg.norm)
    if spec.kind in ("attn", "cross"):
        y, (k, v) = _attn_full(p["attn"], h, spec, cfg, positions, kernels,
                               ctx=ctx if spec.kind == "cross" else None)
        entry = {"k": k, "v": v}
    elif spec.kind == "rec":
        y, (conv, hs) = rglru.apply_rglru(p["rec"], h, cfg)
        entry = {"conv": conv, "h": hs}
    elif spec.kind == "ssm":
        y, (conv, st) = ssm.apply_ssm(p["ssm"], h, cfg)
        entry = {"conv": conv, "state": st}
    else:
        raise ValueError(f"unknown sublayer kind {spec.kind!r}")
    if not cache_capacity:
        return x + y, None
    if spec.kind == "attn":
        entry = _pack_kv_cache(k, v, spec, cache_capacity)
    return x + y, entry


def _sublayer_train(p, spec: LayerSpec, x, cfg, positions, ctx,
                    cache_capacity: int, kernels: str):
    """One prefill (or training) sublayer.  Returns (x, aux, its cache
    entry); aux is a MoE block's load-balance loss (0.0 otherwise)."""
    x, entry = _sublayer_attn(p, spec, x, cfg, positions, ctx,
                              cache_capacity, kernels)
    x, aux = _apply_mlp_part(p, spec, x, cfg)
    return x, aux, entry


def _sublayer_decode(p, spec: LayerSpec, x, cfg, positions, cache):
    """One decode sublayer.  Every state it updates (K/V and positions,
    RG-LRU and SSD states) is written into ``cache`` IN PLACE, so a
    captured step replays against the live cache."""
    h = apply_norm(x, p["norm"], cfg.norm)
    if spec.kind == "attn":
        y, _ = _attn_decode(p["attn"], h, spec, cfg, cache, positions)
    elif spec.kind == "cross":
        y = _cross_decode(p["attn"], h, cfg, cache)
    elif spec.kind == "rec":
        y, (conv, hs) = rglru.apply_rglru(
            p["rec"], h, cfg, conv_state=cache["conv"], h_state=cache["h"],
            decode=True)
        cache["conv"].copy_(conv)
        cache["h"].copy_(hs)
    elif spec.kind == "ssm":
        y, (conv, st) = ssm.apply_ssm(
            p["ssm"], h, cfg, conv_state=cache["conv"],
            ssd_state=cache["state"], decode=True)
        cache["conv"].copy_(conv)
        cache["state"].copy_(st)
    else:
        raise ValueError(f"unknown sublayer kind {spec.kind!r}")
    x, _ = _apply_mlp_part(p, spec, x + y, cfg)
    return x, cache


# ---------------------------------------------------------------------------
# Whole-model passes
# ---------------------------------------------------------------------------


def _run_program(params, prog: Program, x, cfg, positions, ctx=None, *,
                 cache_capacity: int, kernels: str, prefix: str = "",
                 remat: bool = False):
    """Every layer of the program under ``prefix`` in order.  Returns (x,
    aux summed over the layers, caches dict; empty when
    ``cache_capacity`` is 0).

    ``remat`` (with ``cfg.remat == "full"``) runs each group iteration
    under ``torch.utils.checkpoint``: the backward pass recomputes it
    from its input instead of keeping its activations, as the
    reference's ``jax.checkpoint(group_body)``; the leftover layers run
    without it, as there."""
    caches, aux = {}, 0.0

    def group_body(x, aux, layer):
        entries = {}
        for idx, spec in enumerate(prog.group):
            key = f"{prefix}g{idx}"
            x, a, entries[key] = _sublayer_train(
                layer_params(params[key], layer), spec, x, cfg, positions,
                ctx, cache_capacity, kernels)
            aux = aux + a
        return x, aux, entries

    if f"{prefix}g0" in params:     # n_groups may be 0 (depth probes)
        per_layer = []
        for layer in range(prog.n_groups):
            if remat and cfg.remat == "full":
                x, aux, entries = torch.utils.checkpoint.checkpoint(
                    group_body, x, aux, layer, use_reentrant=False)
            else:
                x, aux, entries = group_body(x, aux, layer)
            per_layer.append(entries)
        if cache_capacity:
            for key in per_layer[0]:
                caches[key] = {f: torch.stack([e[key][f] for e in per_layer])
                               for f in per_layer[0][key]}
    for idx, spec in enumerate(prog.leftover):
        key = f"{prefix}x{idx}"
        x, a, entry = _sublayer_train(params[key], spec, x, cfg, positions,
                                      ctx, cache_capacity, kernels)
        aux = aux + a
        if cache_capacity:
            caches[key] = entry
    return x, aux, caches


def _embed(params, tokens):
    return params["embed"][tokens.long()]


def _unembed(params, cfg, x):
    x = apply_norm(x, params["final_norm"], cfg.norm)
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return torch.einsum("bsd,dv->bsv", x, w)


def _encode(params, cfg, frames, kernels: str, remat: bool = False):
    """The encoder program on the frame embeddings [B, Se, d]."""
    x = frames.to(params["w_frontend"].dtype) @ params["w_frontend"]
    pos = torch.arange(frames.shape[1], device=frames.device)[None]
    x, _, _ = _run_program(params, build_encoder_program(cfg), x, cfg, pos,
                           cache_capacity=0, kernels=kernels, prefix="enc_",
                           remat=remat)
    return apply_norm(x, params["enc_final_norm"], cfg.norm)


def _get_ctx(params, cfg, batch, kernels: str, remat: bool = False):
    """The cross sublayers' context: the encoded ``frames`` (enc-dec),
    the projected ``vision`` tokens (cross), else None."""
    if cfg.enc_dec:
        return _encode(params, cfg, batch["frames"], kernels, remat)
    if cfg.cross_every:
        w = params["w_vision_proj"]
        return batch["vision"].to(w.dtype) @ w
    return None


def loss_fn(params, batch, cfg: ArchConfig):
    """Causal LM loss (+ 0.01 * the MoE aux loss), a float32 scalar.
    ``batch``: ``tokens`` / ``labels`` [B,S] (+ ``frames`` or ``vision``).

    Term for term the reference's: the context, the embedded tokens
    through the program (each group iteration recomputed in the backward
    pass under ``cfg.remat == "full"``), the unembedding cast to float32,
    the padded vocabulary masked at -1e9, the mean of logsumexp minus the
    gold logit.  The attention is the plain version (``kernels="torch"``):
    the reference trains through its plain ``block_attention``
    (``repro/models/common.py``); the flash kernel has no backward."""
    tokens, labels = batch["tokens"], batch["labels"]
    prog = build_program(cfg)
    ctx = _get_ctx(params, cfg, batch, "torch", remat=True)
    x = _embed(params, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
    x, aux, _ = _run_program(params, prog, x, cfg, positions, ctx,
                             cache_capacity=0, kernels="torch", remat=True)
    logits = _unembed(params, cfg, x).float()
    Vp, V = cfg.vocab_padded(), cfg.vocab
    if Vp != V:     # mask the padded vocabulary
        logits = logits + torch.where(
            torch.arange(Vp, device=logits.device) < V, 0.0, -1e9)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    ce = torch.mean(logz - gold)
    return ce + 0.01 * aux


def prefill(params, batch, cfg: ArchConfig,
            cache_capacity: Optional[int] = None, last_pos=None, *,
            kernels: str = "hopper"):
    """Run the prompt; returns (logits [B, Vp] at ``last_pos``, cache).

    ``last_pos`` (an int, default S - 1) selects which position's logits
    to return: a server right-pads short prompts to one prefill length,
    and under causal attention a dense model's true last prompt position's
    hidden state equals an unpadded prefill's (not a MoE model's: the pads
    compete with the prompt for expert capacity, as in the reference; nor
    the state that a recurrent or SSD layer carries into decode: it has
    run through the pads, as the reference's has).  ``batch`` holds
    ``tokens`` [B,S], and ``frames`` [B,Se,d] (enc-dec) or ``vision``
    [B,n_vision_tokens,d] (cross).  The cache keeps the activations'
    dtype.  ``kernels`` picks the
    attention: "hopper" (the kernel; its plain version on CPU tensors) or
    "torch"."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    cap = cache_capacity or S
    prog = build_program(cfg)
    ctx = _get_ctx(params, cfg, batch, kernels)
    x = _embed(params, tokens)
    positions = torch.arange(S, device=tokens.device)[None]
    x, _, caches = _run_program(params, prog, x, cfg, positions, ctx,
                                cache_capacity=cap, kernels=kernels)
    last = S - 1 if last_pos is None else int(last_pos)
    logits = _unembed(params, cfg, x[:, last:last + 1])
    return logits[:, 0], caches


# ---------------------------------------------------------------------------
# Decode cache
# ---------------------------------------------------------------------------


def cache_struct(cfg: ArchConfig, batch: int, capacity: int,
                 ctx_len: int = 0) -> dict:
    """The decode cache's layout: {key: {field: (shape, dtype)}}; K/V and
    conv states in bfloat16 whatever the parameters' dtype, RG-LRU and
    SSD states in float32.

    ``capacity``: KV slots of full-attention layers (window layers keep
    min(window, capacity)); ``ctx_len``: the context length of cross
    sublayers."""
    prog = build_program(cfg)
    hd = cfg.resolved_head_dim
    bf16, K1 = torch.bfloat16, cfg.conv_kernel - 1

    def entry(spec: LayerSpec, stacked: int):
        lead = ((stacked,) if stacked else ()) + (batch,)
        if spec.kind == "attn":
            W = min(spec.window, capacity) if spec.window else capacity
            return {"k": (lead + (W, cfg.n_kv, hd), bf16),
                    "v": (lead + (W, cfg.n_kv, hd), bf16),
                    "pos": (lead + (W,), torch.int32)}
        if spec.kind == "cross":
            return {"k": (lead + (ctx_len, cfg.n_kv, hd), bf16),
                    "v": (lead + (ctx_len, cfg.n_kv, hd), bf16)}
        if spec.kind == "rec":
            return {"conv": (lead + (K1, cfg.d_model), bf16),
                    "h": (lead + (cfg.d_model,), torch.float32)}
        if spec.kind == "ssm":
            d_in = cfg.ssm_expand * cfg.d_model
            return {"conv": (lead + (K1, d_in + 2 * cfg.ssm_state), bf16),
                    "state": (lead + (d_in // cfg.ssm_head_dim,
                                      cfg.ssm_head_dim, cfg.ssm_state),
                              torch.float32)}
        raise ValueError(f"unknown sublayer kind {spec.kind!r}")

    shapes = {}
    if prog.n_groups > 0:
        for idx, spec in enumerate(prog.group):
            shapes[f"g{idx}"] = entry(spec, prog.n_groups)
    for idx, spec in enumerate(prog.leftover):
        shapes[f"x{idx}"] = entry(spec, 0)
    return shapes


def init_cache(cfg: ArchConfig, batch: int, capacity: int, device,
               ctx_len: int = 0) -> dict:
    """Zero decode cache on ``device`` (pos slots -1 = empty), laid out
    as ``cache_struct``."""
    def mk(shape, dt):
        if dt == torch.int32:
            return torch.full(shape, -1, dtype=dt, device=device)
        return torch.zeros(shape, dtype=dt, device=device)
    return {key: {f: mk(*sd) for f, sd in entry.items()}
            for key, entry in cache_struct(cfg, batch, capacity,
                                           ctx_len).items()}


def decode_step(params, caches, tokens, positions, cfg: ArchConfig):
    """One token for every sequence: tokens [B,1], positions [B] ->
    (logits [B, Vp], caches).  The new K/V and recurrent states are
    written into ``caches`` IN PLACE (the reference donates its cache to
    the same effect); the returned dict is ``caches`` itself."""
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
