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

Sharding: every function takes the reference's ``axes`` (``MeshAxes``).
``init_lm`` records each leaf's PartitionSpec (``lm_specs``), and
``cache_specs`` the decode cache's, as the reference's ``init_lm`` and
``cache_struct`` give them.  Under a mesh the parameters, caches and
inputs are DTensors placed by those specs, each pass runs under
``axes.scope()`` (plain tensors count as replicated), the reference's
constraints pin the residual (sequence-sharded over tp), the embedding
and the logits, and the attention, the MoE dispatch and every in-place
cache write run per rank (``local_map``), so a write never leaves its
shard.  Off-mesh (``axes.mesh is None``) nothing of this runs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs import ArchConfig
from repro_torch.core import pytree
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru, ssm
from repro_torch.models.common import (MeshAxes, ParamStore, apply_norm,
                                       apply_rope, block_attention,
                                       decode_attention, rope_tables,
                                       row_parallel)


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


def _head_specs(cfg: ArchConfig, axes: MeshAxes):
    """(query-head spec, kv-head spec): tp where it divides the heads."""
    tp = axes.tp_size
    h_spec = axes.tp if cfg.n_heads % max(tp, 1) == 0 else None
    kv_spec = axes.tp if cfg.n_kv % max(tp, 1) == 0 else None
    return h_spec, kv_spec


def _init_norm(store: ParamStore, name: str, d: int, kind: str):
    sub = store.subtree(name)
    # layernorm's scale is drawn at random (1/sqrt(d)), not zeroed
    sub.add("scale", (d,), (None,), zeros=(kind == "rmsnorm"))
    if kind != "rmsnorm":
        sub.add("bias", (d,), (None,), zeros=True)


def _init_attn(store: ParamStore, cfg: ArchConfig, axes: MeshAxes):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h_spec, kv_spec = _head_specs(cfg, axes)
    store.add("wq", (d, cfg.n_heads, hd), (axes.fsdp, h_spec, None))
    store.add("wk", (d, cfg.n_kv, hd), (axes.fsdp, kv_spec, None))
    store.add("wv", (d, cfg.n_kv, hd), (axes.fsdp, kv_spec, None))
    store.add("wo", (cfg.n_heads, hd, d), (h_spec, None, axes.fsdp))
    if cfg.qkv_bias:
        store.add("bq", (cfg.n_heads, hd), (h_spec, None), zeros=True)
        store.add("bk", (cfg.n_kv, hd), (kv_spec, None), zeros=True)
        store.add("bv", (cfg.n_kv, hd), (kv_spec, None), zeros=True)


def _init_sublayer(store: ParamStore, spec: LayerSpec, cfg: ArchConfig,
                   axes: MeshAxes):
    _init_norm(store, "norm", cfg.d_model, cfg.norm)
    if spec.kind in ("attn", "cross"):
        _init_attn(store.subtree("attn"), cfg, axes)
    elif spec.kind == "rec":
        rglru.init_rglru(store.subtree("rec"), cfg, axes)
    elif spec.kind == "ssm":
        ssm.init_ssm(store.subtree("ssm"), cfg, axes)
    if spec.has_mlp:
        _init_norm(store, "mlp_norm", cfg.d_model, cfg.norm)
        mstore = store.subtree("mlp")
        if spec.moe:
            moe_lib.init_moe(mstore, cfg.d_model, cfg.moe, axes)
        elif cfg.act in ("swiglu", "gelu_glu"):
            moe_lib.init_mlp(mstore, cfg.d_model, cfg.d_ff, axes)
        else:
            moe_lib.init_mlp_nonglu(mstore, cfg.d_model, cfg.d_ff, axes)


def _build_lm(generator, cfg: ArchConfig, device, dtype,
              axes: MeshAxes) -> ParamStore:
    store = ParamStore(generator, device, dtype)
    Vp = cfg.vocab_padded()
    store.add("embed", (Vp, cfg.d_model), (axes.tp, axes.fsdp), scale=0.02)
    if not cfg.tie_embeddings:
        store.add("unembed", (cfg.d_model, Vp), (axes.fsdp, axes.tp),
                  scale=0.02)
    _init_norm(store, "final_norm", cfg.d_model, cfg.norm)
    _init_program(store, build_program(cfg), cfg, axes, "")
    if cfg.enc_dec:
        store.add("w_frontend", (cfg.d_model, cfg.d_model),
                  (axes.fsdp, None))
        _init_norm(store, "enc_final_norm", cfg.d_model, cfg.norm)
        _init_program(store, build_encoder_program(cfg), cfg, axes, "enc_")
    if cfg.cross_every:
        store.add("w_vision_proj", (cfg.d_model, cfg.d_model),
                  (axes.fsdp, None))
    return store


def init_lm(generator: torch.Generator, cfg: ArchConfig, device,
            dtype=torch.bfloat16) -> dict:
    """Random parameters on ``device`` from ``generator``, with the
    reference's shapes, distributions and scales (not its bits)."""
    return _build_lm(generator, cfg, device, dtype, MeshAxes()).params


def lm_specs(cfg: ArchConfig, axes: MeshAxes = MeshAxes()) -> dict:
    """Each parameter's PartitionSpec as a tuple, in ``init_lm``'s tree
    (the reference's ``init_lm(...)[1]``); nothing is allocated."""
    return _build_lm(None, cfg, "meta", torch.bfloat16, axes).specs


def _init_program(store: ParamStore, prog: Program, cfg: ArchConfig,
                  axes: MeshAxes, prefix: str):
    """The program's sublayers under ``{prefix}g{idx}`` (stacked) and
    ``{prefix}x{idx}``."""
    if prog.n_groups:
        for idx, spec in enumerate(prog.group):
            sub = ParamStore(store.generator, store.device, store.dtype,
                             stack=prog.n_groups)
            _init_sublayer(sub, spec, cfg, axes)
            store.params[f"{prefix}g{idx}"] = sub.params
            store.specs[f"{prefix}g{idx}"] = sub.specs
    for idx, spec in enumerate(prog.leftover):
        _init_sublayer(store.subtree(f"{prefix}x{idx}"), spec, cfg, axes)


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


def _attn_full(p, x, spec: LayerSpec, cfg, positions, kernels, ctx=None,
               axes: MeshAxes = MeshAxes()):
    """Prefill attention.  Returns (out, (k, v)); k, v for the cache.
    With a context (cross): no RoPE, not causal, no window."""
    q, k, v = _qkv(p, x, cfg, ctx)
    if ctx is None:
        sin, cos = rope_tables(positions, cfg.resolved_head_dim,
                               cfg.rope_theta)
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
    h_spec, kv_spec = _head_specs(cfg, axes)
    out = block_attention(q, k, v, causal=spec.causal and ctx is None,
                          window=spec.window if ctx is None else 0,
                          kernels=kernels, axes=axes,
                          head_sharded=h_spec is not None,
                          kv_sharded=kv_spec is not None)
    return row_parallel(out, p["wo"], axes, "bshk,hkd->bsd"), (k, v)


def _cache_layout(cfg: ArchConfig, batch: int, axes: MeshAxes):
    """(batch spec, sequence spec, kv-head spec) of the decode cache's
    K/V, as the reference's ``cache_struct`` lays them out: the batch on
    dp when dp divides it, else the sequence on dp's last axis; under
    ``decode_cache_seq_shard == "tp"`` with KV heads that tp does not
    divide, the sequence on tp (split-KV)."""
    _, kv_spec = _head_specs(cfg, axes)
    batch_ok = axes.mesh is None or batch % axes.dp_size == 0
    b_spec = axes.dp if batch_ok else None
    s_spec = None if batch_ok else axes.dp[-1]
    if cfg.decode_cache_seq_shard == "tp" and kv_spec is None:
        s_spec = axes.tp if axes.mesh is not None else None
        kv_spec = None
    return b_spec, s_spec, kv_spec


def _assign(dst, src):
    """dst <- src in place, on ``dst``'s placements under a mesh."""
    from torch.distributed.tensor import DTensor
    if isinstance(dst, DTensor) and isinstance(src, DTensor):
        src = src.redistribute(dst.device_mesh, dst.placements)
    dst.copy_(src.to(dst.dtype))


def _write_slots(dst, new, positions, axes: MeshAxes, b_spec, s_spec,
                 *rest):
    """dst[b, positions[b] % W] = new[b] IN PLACE (dst [B, W, ...], new
    [B, ...]).  Under a mesh each rank writes its own shard (``local_map``:
    ``rest`` is the spec of dst's dims after W): the batch rows it holds
    and, when the sequence is sharded (``s_spec``), only the slot it
    holds, found by comparing its share of the slot ids."""
    W = dst.shape[1]
    if axes.mesh is None:
        slot = (positions % W).long()
        bidx = torch.arange(dst.shape[0], device=dst.device)
        dst[bidx, slot] = new.to(dst.dtype)
        return
    from torch.distributed.tensor.experimental import local_map
    ids = axes.constrain(torch.arange(W, device=positions.device), s_spec)

    def local(d, n, pos, sid):
        slot = (pos % W).long()
        if s_spec is None:
            d[torch.arange(d.shape[0], device=d.device), slot] = \
                n.to(d.dtype)
        else:
            hit = sid[None, :] == slot[:, None]
            hit = hit.reshape(hit.shape + (1,) * (d.dim() - 2))
            d.copy_(torch.where(hit, n[:, None].to(d.dtype), d))
        return d

    d_pl = axes.placements(dst.dim(), b_spec, s_spec, *rest)
    if tuple(dst.placements) != tuple(d_pl):
        raise ValueError(f"decode cache placed {dst.placements}, want "
                         f"{tuple(d_pl)}: a write into a redistributed "
                         f"copy would be lost")
    local_map(local, out_placements=(d_pl,),
              in_placements=(d_pl, axes.placements(new.dim(), b_spec, *rest),
                             axes.placements(1, b_spec),
                             axes.placements(1, s_spec)),
              device_mesh=axes.mesh, redistribute_inputs=True)(
        dst, new, positions, ids)


def _attn_decode(p, x, spec: LayerSpec, cfg, cache, positions,
                 axes: MeshAxes = MeshAxes()):
    """Single-token attention; writes the new K/V into the ring-buffer
    cache IN PLACE (slot = position % W) and returns (out, cache)."""
    q, k_new, v_new = _qkv(p, x, cfg)
    sin, cos = rope_tables(positions[:, None], cfg.resolved_head_dim,
                           cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k_new = apply_rope(k_new, sin, cos)
    b_spec, s_spec, kv_spec = _cache_layout(cfg, x.shape[0], axes)
    _write_slots(cache["k"], k_new[:, 0], positions, axes, b_spec, s_spec,
                 kv_spec, None)
    _write_slots(cache["v"], v_new[:, 0], positions, axes, b_spec, s_spec,
                 kv_spec, None)
    _write_slots(cache["pos"], positions, positions, axes, b_spec, s_spec)
    seq_spec = None
    if axes.mesh is not None and x.shape[0] % axes.dp_size != 0:
        seq_spec = axes.dp[-1]  # batch unshardable: KV sequence on data
    if cfg.decode_cache_seq_shard == "tp" and _head_specs(cfg, axes)[1] \
            is None and axes.mesh is not None:
        seq_spec = axes.tp      # split-KV across the model axis
    out = decode_attention(q, cache["k"], cache["v"], cache["pos"],
                           positions, window=spec.window, axes=axes,
                           seq_axis_spec=seq_spec)
    return row_parallel(out, p["wo"], axes, "bshk,hkd->bsd"), cache


def _cross_decode(p, x, cfg, cache, axes: MeshAxes = MeshAxes()):
    """Decode-time cross-attention against the context's (k, v), all of
    it visible."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    k_c = cache["k"]
    pos = torch.zeros(x.shape[0], dtype=torch.int32, device=x.device)
    kv_pos = torch.zeros(k_c.shape[:2], dtype=torch.int32, device=x.device)
    out = decode_attention(q, k_c, cache["v"], kv_pos, pos, axes=axes)
    return row_parallel(out, p["wo"], axes, "bshk,hkd->bsd")


def _apply_mlp_part(p, spec: LayerSpec, x, cfg, axes: MeshAxes = MeshAxes()):
    """The MLP half of a sublayer on the residual ``x``: (x + mlp, aux),
    aux the MoE load-balance loss (0.0 for a dense MLP)."""
    if not spec.has_mlp:
        return x, 0.0
    h = _gather_seq(apply_norm(x, p["mlp_norm"], cfg.norm), axes)
    if spec.moe:
        y, aux = moe_lib.apply_moe(p["mlp"], h, cfg.moe, cfg.act,
                                   dispatch=cfg.moe_dispatch, axes=axes)
    elif cfg.act in ("swiglu", "gelu_glu"):
        y, aux = moe_lib.apply_mlp(p["mlp"], h, cfg.act, axes), 0.0
    else:
        y, aux = moe_lib.apply_mlp_nonglu(p["mlp"], h, cfg.act, axes), 0.0
    return x + _block_output(y, cfg, axes), aux


def _pack_kv_cache(k, v, spec: LayerSpec, capacity: int):
    """Arrange prefill K/V into the ring-buffer layout (slot = pos % W).
    When the prefill fills the ring, the kept positions are rotated into
    place (the slots of positions S-W..S-1 are a rotation of 0..W-1)."""
    B, S = k.shape[:2]
    W = min(capacity, spec.window) if spec.window else capacity
    dev = k.device
    if S >= W:
        # slot j holds position S - W + ((j - S) mod W): the kept tail
        # rotated, as two slices (DTensor has no rule for roll everywhere)
        cut = W - (S - W) % W

        def rot(t):
            t = t[:, S - W:]
            return torch.cat([t[:, cut:], t[:, :cut]], dim=1)
        k_c, v_c = rot(k), rot(v)
        pos_c = rot(torch.arange(S, dtype=torch.int32,
                                 device=dev).expand(B, S))
    else:
        pad = W - S
        k_c = torch.cat([k, k.new_zeros((B, pad) + k.shape[2:])], dim=1)
        v_c = torch.cat([v, v.new_zeros((B, pad) + v.shape[2:])], dim=1)
        pos_c = torch.cat(
            [torch.arange(S, dtype=torch.int32, device=dev).expand(B, S),
             torch.full((B, pad), -1, dtype=torch.int32, device=dev)], dim=1)
    return {"k": k_c, "v": v_c, "pos": pos_c}


def _sublayer_attn(p, spec: LayerSpec, x, cfg, positions, ctx,
                   cache_capacity: int, kernels: str,
                   axes: MeshAxes = MeshAxes()):
    """The token-mixing half of a prefill sublayer: attention, cross-
    attention (to ``ctx``), RG-LRU or SSD.  Returns (the residual after
    it, its cache entry; None when ``cache_capacity`` is 0, as for the
    encoder)."""
    h = _gather_seq(apply_norm(x, p["norm"], cfg.norm), axes)
    if spec.kind in ("attn", "cross"):
        y, (k, v) = _attn_full(p["attn"], h, spec, cfg, positions, kernels,
                               ctx=ctx if spec.kind == "cross" else None,
                               axes=axes)
        entry = {"k": k, "v": v}
    elif spec.kind == "rec":
        y, (conv, hs) = rglru.apply_rglru(p["rec"], h, cfg, axes=axes)
        entry = {"conv": conv, "h": hs}
    elif spec.kind == "ssm":
        y, (conv, st) = ssm.apply_ssm(p["ssm"], h, cfg, axes=axes)
        entry = {"conv": conv, "state": st}
    else:
        raise ValueError(f"unknown sublayer kind {spec.kind!r}")
    y = _block_output(y, cfg, axes)
    x = axes.constrain(x + y, axes.batch(x.shape[0]),
                       _seq_spec(axes, x.shape[1]), None)  # seq-sharded
    if not cache_capacity:
        return x, None
    if spec.kind == "attn":
        entry = _pack_kv_cache(k, v, spec, cache_capacity)
    return x, entry


def _sublayer_train(p, spec: LayerSpec, x, cfg, positions, ctx,
                    cache_capacity: int, kernels: str,
                    axes: MeshAxes = MeshAxes()):
    """One prefill (or training) sublayer.  Returns (x, aux, its cache
    entry); aux is a MoE block's load-balance loss (0.0 otherwise)."""
    p = axes.unshard_fsdp(p)
    x, entry = _sublayer_attn(p, spec, x, cfg, positions, ctx,
                              cache_capacity, kernels, axes)
    x, aux = _apply_mlp_part(p, spec, x, cfg, axes)
    return axes.constrain(x, axes.batch(x.shape[0]),
                          _seq_spec(axes, x.shape[1]), None), \
        aux, entry


def _sublayer_decode(p, spec: LayerSpec, x, cfg, positions, cache,
                     axes: MeshAxes = MeshAxes()):
    """One decode sublayer.  Every state it updates (K/V and positions,
    RG-LRU and SSD states) is written into ``cache`` IN PLACE, so a
    captured step replays against the live cache."""
    p = axes.unshard_fsdp(p)
    h = apply_norm(x, p["norm"], cfg.norm)
    if spec.kind == "attn":
        y, _ = _attn_decode(p["attn"], h, spec, cfg, cache, positions, axes)
    elif spec.kind == "cross":
        y = _cross_decode(p["attn"], h, cfg, cache, axes)
    elif spec.kind == "rec":
        y, (conv, hs) = rglru.apply_rglru(
            p["rec"], h, cfg, conv_state=cache["conv"], h_state=cache["h"],
            decode=True, axes=axes)
        _assign(cache["conv"], conv)
        _assign(cache["h"], hs)
    elif spec.kind == "ssm":
        y, (conv, st) = ssm.apply_ssm(
            p["ssm"], h, cfg, conv_state=cache["conv"],
            ssd_state=cache["state"], decode=True, axes=axes)
        _assign(cache["conv"], conv)
        _assign(cache["state"], st)
    else:
        raise ValueError(f"unknown sublayer kind {spec.kind!r}")
    x, _ = _apply_mlp_part(p, spec, x + y, cfg, axes)
    return x, cache


# ---------------------------------------------------------------------------
# Whole-model passes
# ---------------------------------------------------------------------------


def _run_program(params, prog: Program, x, cfg, positions, ctx=None, *,
                 cache_capacity: int, kernels: str, prefix: str = "",
                 remat: bool = False, axes: MeshAxes = MeshAxes()):
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
        with axes.scope():      # also when the backward recomputes it
            for idx, spec in enumerate(prog.group):
                key = f"{prefix}g{idx}"
                x, a, entries[key] = _sublayer_train(
                    layer_params(params[key], layer), spec, x, cfg,
                    positions, ctx, cache_capacity, kernels, axes)
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
                                      ctx, cache_capacity, kernels, axes)
        aux = aux + a
        if cache_capacity:
            caches[key] = entry
    return x, aux, caches


def _block_output(y, cfg, axes: MeshAxes):
    """A block's output [B,S,d] before the residual add: with
    ``cfg.sp_outputs`` on the sequence-sharded layout (the TP partial sum
    reduces as a reduce-scatter, Megatron-SP), else whole (an
    all-reduce), so the gradient that reaches the block's matmuls is
    never split over the flattened (batch, sequence) rows."""
    if axes.mesh is None or y.dim() != 3:
        return y
    sp = _seq_spec(axes, y.shape[1]) if cfg.sp_outputs else None
    return axes.constrain(y, axes.batch(y.shape[0]), sp, None)


def _gather_seq(h, axes: MeshAxes):
    """A block's input off the sequence-sharded residual: the sequence
    whole again (the all-gather that sequence parallelism pairs with the
    block output's reduce-scatter), the batch on dp."""
    return axes.constrain(h, axes.batch(h.shape[0]), None, None)


def _seq_spec(axes: MeshAxes, S: int):
    """The residual's sequence spec: tp (the reference's sequence-sharded
    residual) when tp divides the sequence; a decode step's one position
    stays whole."""
    return axes.tp if S % max(axes.tp_size, 1) == 0 else None


def _embed(params, tokens, axes: MeshAxes = MeshAxes()):
    if axes.mesh is None:
        return params["embed"][tokens.long()]
    # the vocabulary-sharded lookup takes the token ids whole: each tp
    # rank gathers the rows it holds and zeros for the others, and the
    # partial sum (one row and zeros: exact) reduces over tp; no boolean
    # mask, so no host read, and a captured step replays it.  The rows
    # then go to the sequence-sharded layout
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    w = axes.unshard_fsdp(params["embed"])
    whole = [Replicate()] * axes.mesh.ndim
    out = [Partial() if p.is_shard() else p for p in w.placements]
    ids = axes.constrain(torch.arange(w.shape[0], device=w.device))
    ids = ids.redistribute(axes.mesh, w.placements)

    def lookup(w_, tok, ids_):
        row = tok.long() - ids_[:1]
        hit = (row >= 0) & (row < w_.shape[0])
        x = w_[row.clamp(0, w_.shape[0] - 1)]
        return torch.where(hit[..., None], x, torch.zeros((), dtype=x.dtype,
                                                           device=x.device))
    x = local_map(lookup, out_placements=(out,),
                  in_placements=(w.placements, whole, w.placements),
                  device_mesh=axes.mesh, redistribute_inputs=True)(
                      w, axes.constrain(tokens), ids)
    x = x.redistribute(axes.mesh, [Replicate() if p.is_partial() else p
                                   for p in x.placements])
    return axes.constrain(x, axes.batch(x.shape[0]),
                          _seq_spec(axes, x.shape[1]), None)


def _unembed(params, cfg, x, axes: MeshAxes = MeshAxes()):
    x = _gather_seq(apply_norm(x, params["final_norm"], cfg.norm), axes)
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = torch.einsum("bsd,dv->bsv", x, axes.unshard_fsdp(w))
    return axes.constrain(logits, axes.batch(x.shape[0]), None, axes.tp)


def _encode(params, cfg, frames, kernels: str, remat: bool = False,
            axes: MeshAxes = MeshAxes()):
    """The encoder program on the frame embeddings [B, Se, d]."""
    x = frames.to(params["w_frontend"].dtype) @ params["w_frontend"]
    pos = torch.arange(frames.shape[1], device=frames.device)[None]
    x, _, _ = _run_program(params, build_encoder_program(cfg), x, cfg, pos,
                           cache_capacity=0, kernels=kernels, prefix="enc_",
                           remat=remat, axes=axes)
    return apply_norm(x, params["enc_final_norm"], cfg.norm)


def _get_ctx(params, cfg, batch, kernels: str, remat: bool = False,
             axes: MeshAxes = MeshAxes()):
    """The cross sublayers' context: the encoded ``frames`` (enc-dec),
    the projected ``vision`` tokens (cross), else None."""
    if cfg.enc_dec:     # the encoder's output with its sequence whole
        return _gather_seq(_encode(params, cfg, batch["frames"], kernels,
                                   remat, axes), axes)
    if cfg.cross_every:
        w = params["w_vision_proj"]
        return batch["vision"].to(w.dtype) @ w
    return None


def loss_fn(params, batch, cfg: ArchConfig, axes: MeshAxes = MeshAxes()):
    """Causal LM loss (+ 0.01 * the MoE aux loss), a float32 scalar.
    ``batch``: ``tokens`` / ``labels`` [B,S] (+ ``frames`` or ``vision``).

    Term for term the reference's: the context, the embedded tokens
    through the program (each group iteration recomputed in the backward
    pass under ``cfg.remat == "full"``), the unembedding cast to float32,
    the padded vocabulary masked at -1e9, the mean of logsumexp minus the
    gold logit.  The attention is the plain version (``kernels="torch"``):
    the reference trains through its plain ``block_attention``
    (``repro/models/common.py``); the flash kernel has no backward."""
    with axes.scope():
        return _loss(params, batch, cfg, axes)


def _loss(params, batch, cfg: ArchConfig, axes: MeshAxes):
    tokens, labels = batch["tokens"], batch["labels"]
    prog = build_program(cfg)
    ctx = _get_ctx(params, cfg, batch, "torch", remat=True, axes=axes)
    x = _embed(params, tokens, axes)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
    x, aux, _ = _run_program(params, prog, x, cfg, positions, ctx,
                             cache_capacity=0, kernels="torch", remat=True,
                             axes=axes)
    logits = _unembed(params, cfg, x, axes).float()
    Vp, V = cfg.vocab_padded(), cfg.vocab
    if Vp != V:     # mask the padded vocabulary
        logits = logits + torch.where(
            torch.arange(Vp, device=logits.device) < V, 0.0, -1e9)
    logz = torch.logsumexp(logits, dim=-1)
    if axes.mesh is None:
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    else:   # the gold logit from each rank's vocabulary shard, summed
        ids = axes.constrain(torch.arange(Vp, device=logits.device),
                             axes.tp)
        gold = torch.where(labels.long()[..., None] == ids, logits,
                           0.0).sum(dim=-1)
    ce = torch.mean(logz - gold)
    return ce + 0.01 * aux


def prefill(params, batch, cfg: ArchConfig,
            cache_capacity: Optional[int] = None, last_pos=None, *,
            kernels: str = "hopper", axes: MeshAxes = MeshAxes()):
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
    with axes.scope():
        tokens = batch["tokens"]
        B, S = tokens.shape
        cap = cache_capacity or S
        prog = build_program(cfg)
        ctx = _get_ctx(params, cfg, batch, kernels, axes=axes)
        x = _embed(params, tokens, axes)
        positions = torch.arange(S, device=tokens.device)[None]
        x, _, caches = _run_program(params, prog, x, cfg, positions, ctx,
                                    cache_capacity=cap, kernels=kernels,
                                    axes=axes)
        last = S - 1 if last_pos is None else int(last_pos)
        logits = _unembed(params, cfg, x[:, last:last + 1], axes)
        if axes.mesh is not None:   # the cache on its decode layout
            caches = pytree.dict_map(lambda t, sp: axes.constrain(t, *sp),
                                     caches, cache_specs(cfg, B, axes))
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


def cache_specs(cfg: ArchConfig, batch: int, axes: MeshAxes = MeshAxes()
                ) -> dict:
    """The decode cache's PartitionSpecs (tuples) in ``cache_struct``'s
    tree, the reference's ``cache_struct(...)[1]``: K/V on
    ``_cache_layout``'s (batch, sequence, kv-head) specs, a rec entry's
    width and an ssm entry's heads on tp, a stacked entry with a leading
    None."""
    prog = build_program(cfg)
    b_spec, s_spec, kv_spec = _cache_layout(cfg, batch, axes)

    def entry(spec: LayerSpec, stacked: bool):
        lead = (None,) if stacked else ()
        if spec.kind == "attn":
            return {"k": lead + (b_spec, s_spec, kv_spec, None),
                    "v": lead + (b_spec, s_spec, kv_spec, None),
                    "pos": lead + (b_spec, s_spec)}
        if spec.kind == "cross":
            return {"k": lead + (b_spec, None, kv_spec, None),
                    "v": lead + (b_spec, None, kv_spec, None)}
        if spec.kind == "rec":
            return {"conv": lead + (b_spec, None, axes.tp),
                    "h": lead + (b_spec, axes.tp)}
        if spec.kind == "ssm":
            return {"conv": lead + (b_spec, None, None),
                    "state": lead + (b_spec, axes.tp, None, None)}
        raise ValueError(f"unknown sublayer kind {spec.kind!r}")

    specs = {}
    if prog.n_groups > 0:
        for idx, spec in enumerate(prog.group):
            specs[f"g{idx}"] = entry(spec, True)
    for idx, spec in enumerate(prog.leftover):
        specs[f"x{idx}"] = entry(spec, False)
    return specs


def init_cache(cfg: ArchConfig, batch: int, capacity: int, device,
               ctx_len: int = 0, axes: MeshAxes = MeshAxes()) -> dict:
    """Zero decode cache on ``device`` (pos slots -1 = empty), laid out
    as ``cache_struct``; under a mesh each field placed by
    ``cache_specs``."""
    def mk(shape, dt):
        if dt == torch.int32:
            return torch.full(shape, -1, dtype=dt, device=device)
        return torch.zeros(shape, dtype=dt, device=device)
    specs = cache_specs(cfg, batch, axes)
    return {key: {f: axes.distribute(mk(*sd), *specs[key][f])
                  for f, sd in entry.items()}
            for key, entry in cache_struct(cfg, batch, capacity,
                                           ctx_len).items()}


def decode_step(params, caches, tokens, positions, cfg: ArchConfig,
                axes: MeshAxes = MeshAxes()):
    """One token for every sequence: tokens [B,1], positions [B] ->
    (logits [B, Vp], caches).  The new K/V and recurrent states are
    written into ``caches`` IN PLACE (the reference donates its cache to
    the same effect); the returned dict is ``caches`` itself."""
    with axes.scope():
        prog = build_program(cfg)
        x = _embed(params, tokens, axes)
        for layer in range(prog.n_groups if "g0" in params else 0):
            for idx, spec in enumerate(prog.group):
                key = f"g{idx}"
                x, _ = _sublayer_decode(layer_params(params[key], layer),
                                        spec, x, cfg, positions,
                                        layer_params(caches[key], layer),
                                        axes)
        for idx, spec in enumerate(prog.leftover):
            key = f"x{idx}"
            x, _ = _sublayer_decode(params[key], spec, x, cfg, positions,
                                    caches[key], axes)
        logits = _unembed(params, cfg, x, axes)
        return logits[:, 0], caches
