"""Architecture configs of the port (``repro.configs``'s counterpart).

One module per architecture (public-literature specs, the same data as the
JAX package's, kept as the port's own copies) plus the paper's own
TPC-W/SharedDB engine config.  ``get_config(arch_id)`` is the single lookup
used by the LM server, its launcher, the tests and ``chip_smoke.py``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Optional

# ---------------------------------------------------------------------------
# Shape suite (assigned): every LM arch is exercised on these four shapes.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    num_shared: int = 0
    d_ff_expert: int = 0           # per-expert FFN width
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Unified architecture description for the model zoo."""

    name: str
    family: str                    # dense|moe|ssm|hybrid|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    moe: Optional[MoEConfig] = None
    # Attention pattern: window > 0 means sliding-window on "local" layers.
    window: int = 0
    # local:global interleave, e.g. (5, 1) = 5 local then 1 global; (0, 1) =
    # all global.  Lowered as a uniform scan with a per-layer pattern mask.
    local_global: tuple = (0, 1)
    # Encoder-decoder (whisper): encoder layers share the width above.
    enc_dec: bool = False
    n_enc_layers: int = 0
    dec_ratio: int = 8             # dec_len = seq_len // dec_ratio for enc-dec
    # VLM: one cross-attention layer every `cross_every` layers.
    cross_every: int = 0
    n_vision_tokens: int = 6404
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_kernel: int = 4
    # Hybrid (recurrentgemma): pattern of block kinds per scan group.
    rglru_pattern: tuple = ()      # e.g. ("rec", "rec", "attn")
    # Shapes this arch supports (long_500k only for sub-quadratic attn).
    skip_shapes: tuple = ()
    skip_reason: str = ""
    # Norm / activation flavour
    act: str = "swiglu"
    norm: str = "rmsnorm"
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    source: str = ""
    # performance knobs (hillclimbed in EXPERIMENTS.md §Perf)
    moe_dispatch: str = "sort"     # sort | onehot | sharded
    remat: str = "full"            # full | none
    # decode: shard the KV-cache sequence dim over the TP axis (split-KV
    # flash-decoding) — the fix for GQA archs whose kv heads < tp size
    decode_cache_seq_shard: str = "none"   # none | tp
    # constrain sublayer OUTPUTS (pre-residual-add) to the seq-sharded
    # layout so TP reductions lower as reduce-scatter instead of all-reduce
    sp_outputs: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    def vocab_padded(self, multiple: int = 2048) -> int:
        return ((self.vocab + multiple - 1) // multiple) * multiple

    def param_count(self) -> int:
        """Analytic parameter count (total; MoE counts all experts)."""
        d, ff, L = self.d_model, self.d_ff, self.n_layers
        hd = self.resolved_head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv * hd) \
            + (self.n_heads * hd) * d
        if self.family == "ssm":
            d_in = self.ssm_expand * d
            nh = d_in // self.ssm_head_dim
            # in_proj (z,x,B,C,dt) + out_proj + conv
            per = d * (2 * d_in + 2 * self.ssm_state + nh) + d_in * d \
                + self.conv_kernel * (d_in + 2 * self.ssm_state)
            body = per * L
        elif self.moe is not None:
            ffe = self.moe.d_ff_expert or ff
            dense_ff = 3 * d * ff * self.moe.num_shared
            expert_ff = 3 * d * ffe * self.moe.num_experts
            router = d * self.moe.num_experts
            body = (attn + dense_ff + expert_ff + router) * L
        else:
            body = (attn + 3 * d * ff) * L
        if self.rglru_pattern:
            # recurrent blocks replace attention in a fraction of layers
            n_rec = sum(1 for k in self.rglru_pattern if k == "rec")
            frac = n_rec / len(self.rglru_pattern)
            d_rnn = d
            rec = d * d_rnn * 2 + d_rnn * d + 3 * d_rnn  # gates + proj + lru
            body = int(L * (frac * (rec + 3 * d * ff)
                            + (1 - frac) * (attn + 3 * d * ff)))
        emb = self.vocab_padded() * d
        unemb = 0 if self.tie_embeddings else self.vocab_padded() * d
        if self.enc_dec:
            enc = (attn + 3 * d * ff) * self.n_enc_layers
            xattn = attn * L  # decoder cross-attention
            body += enc + xattn
        if self.cross_every:
            n_cross = self.n_layers // self.cross_every
            body += attn * n_cross
        return body + emb + unemb

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.param_count()
        d, ff, L = self.d_model, self.d_ff, self.n_layers
        hd = self.resolved_head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv * hd) \
            + (self.n_heads * hd) * d
        ffe = self.moe.d_ff_expert or ff
        active_ff = 3 * d * ffe * (self.moe.top_k + self.moe.num_shared)
        router = d * self.moe.num_experts
        body = (attn + active_ff + router) * L
        emb = self.vocab_padded() * d
        unemb = 0 if self.tie_embeddings else self.vocab_padded() * d
        return body + emb + unemb

    def supports(self, shape_name: str) -> bool:
        return shape_name not in self.skip_shapes


ARCH_IDS = [
    "whisper-small",
    "mixtral-8x22b",
    "qwen2-moe-a2.7b",
    "yi-6b",
    "qwen2-72b",
    "gemma3-27b",
    "stablelm-1.6b",
    "llama-3.2-vision-90b",
    "mamba2-370m",
    "recurrentgemma-2b",
]

_MODULES = {
    "whisper-small": "whisper_small",
    "mixtral-8x22b": "mixtral_8x22b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "yi-6b": "yi_6b",
    "qwen2-72b": "qwen2_72b",
    "gemma3-27b": "gemma3_27b",
    "stablelm-1.6b": "stablelm_1_6b",
    "llama-3.2-vision-90b": "llama3_2_vision_90b",
    "mamba2-370m": "mamba2_370m",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "shareddb-tpcw": "shareddb_tpcw",
}


def get_config(arch_id: str) -> Any:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def smoke_config(arch_id: str) -> "ArchConfig":
    """Reduced same-family config for CPU smoke tests."""
    cfg = get_config(arch_id)
    if not isinstance(cfg, ArchConfig):
        raise TypeError(f"{arch_id} is not an LM arch config")
    small = dict(
        n_layers=max(2, len(cfg.rglru_pattern) or 0) or 2,
        d_model=64,
        n_heads=4,
        n_kv=min(cfg.n_kv, 4) if cfg.n_kv else 0,
        head_dim=16,
        d_ff=128,
        vocab=256,
        n_enc_layers=2 if cfg.enc_dec else 0,
        cross_every=2 if cfg.cross_every else 0,
        n_vision_tokens=8 if cfg.cross_every else cfg.n_vision_tokens,
        window=8 if cfg.window else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else cfg.ssm_head_dim,
        ssm_chunk=8 if cfg.ssm_state else cfg.ssm_chunk,
    )
    if cfg.moe is not None:
        small["moe"] = MoEConfig(
            num_experts=4, top_k=min(cfg.moe.top_k, 2),
            num_shared=min(cfg.moe.num_shared, 1), d_ff_expert=64)
    if cfg.rglru_pattern:
        small["n_layers"] = len(cfg.rglru_pattern)
    loc, glob = cfg.local_global
    if loc and glob:
        small["n_layers"] = loc + glob + 1   # one full group + leftover
    if cfg.cross_every:
        small["n_layers"] = 2 * (small["cross_every"] or cfg.cross_every)
    return dataclasses.replace(cfg, **small)
