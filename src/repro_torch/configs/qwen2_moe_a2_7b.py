"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed experts, top-4.

[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]  Full attention -> long_500k skipped.
"""
from repro_torch.configs import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    head_dim=128,
    d_ff=1408,
    vocab=151936,
    qkv_bias=True,
    moe=MoEConfig(num_experts=60, top_k=4, num_shared=4, d_ff_expert=1408),
    act="swiglu",
    # shipped default = shard-local dispatch (EXPERIMENTS.md §Perf: 6.5-8.3x
    # vs the global-sort baseline; reproduce baseline via moe_dispatch=sort)
    moe_dispatch="sharded",
    skip_shapes=("long_500k",),
    skip_reason="pure full attention; 500k KV decode excluded per shape "
                "applicability rules — see DESIGN.md",
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)
