"""qwen2-72b [dense] — GQA with QKV bias.  [arXiv:2407.10671; hf]"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    head_dim=128,
    d_ff=29568,
    vocab=152064,
    qkv_bias=True,
    act="swiglu",
    rope_theta=1e6,
    skip_shapes=("long_500k",),
    skip_reason="pure full attention — see DESIGN.md",
    source="arXiv:2407.10671",
)
