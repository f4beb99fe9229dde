"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 2:1 pattern.

[arXiv:2402.19427; hf]  Griffin-style: two recurrent (RG-LRU) blocks per
local-attention (MQA, window 2048) block.  Constant recurrent state + bounded
window -> all shapes run, including long_500k.
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv=1,                      # MQA
    head_dim=256,
    d_ff=7680,
    vocab=256000,
    window=2048,
    rglru_pattern=("rec", "rec", "attn"),
    act="gelu_glu",
    tie_embeddings=True,
    source="arXiv:2402.19427",
)
