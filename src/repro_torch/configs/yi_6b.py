"""yi-6b [dense] — llama-architecture GQA.  [arXiv:2403.04652; hf]"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=4,
    head_dim=128,
    d_ff=11008,
    vocab=64000,
    act="swiglu",
    rope_theta=5e6,
    skip_shapes=("long_500k",),
    skip_reason="pure full attention — see DESIGN.md",
    source="arXiv:2403.04652",
)
