"""stablelm-1.6b [dense].  [hf:stabilityai/stablelm-2-1_6b; unverified]"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv=32,
    head_dim=64,
    d_ff=5632,
    vocab=100352,
    act="swiglu",
    norm="layernorm",
    skip_shapes=("long_500k",),
    skip_reason="pure full attention — see DESIGN.md",
    source="hf:stabilityai/stablelm-2-1_6b",
)
