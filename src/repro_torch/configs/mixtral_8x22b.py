"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention.

[arXiv:2401.04088; hf]  SWA window 4096 bounds the KV cache, so the
long_500k decode shape runs (sub-quadratic).
"""
from repro_torch.configs import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv=8,
    head_dim=128,
    d_ff=16384,
    vocab=32768,
    moe=MoEConfig(num_experts=8, top_k=2, num_shared=0, d_ff_expert=16384),
    window=4096,
    local_global=(1, 0),         # all layers sliding-window
    act="swiglu",
    # shipped default = shard-local dispatch (EXPERIMENTS.md §Perf: 6.5-8.3x
    # vs the global-sort baseline; reproduce baseline via moe_dispatch=sort)
    moe_dispatch="sharded",
    rope_theta=1e6,
    source="arXiv:2401.04088",
)
