"""llama-3.2-vision-90b [vlm] — cross-attention image layers.

[hf:meta-llama/Llama-3.2-11B-Vision; unverified]  Backbone only: the vision
tower is a stub; ``input_specs`` provides precomputed, projected patch
embeddings (n_vision_tokens x d_model).  One cross-attn layer per five.
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    head_dim=128,
    d_ff=28672,
    vocab=128256,
    cross_every=5,
    n_vision_tokens=6404,        # 4 tiles x 1601 patch tokens
    act="swiglu",
    rope_theta=5e5,
    skip_shapes=("long_500k",),
    skip_reason="pure full attention — see DESIGN.md",
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)
