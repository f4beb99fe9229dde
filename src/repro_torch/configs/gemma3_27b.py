"""gemma3-27b [dense] — 5:1 local:global attention, 128k context.

[hf:google/gemma-3-1b-pt; unverified]  Local window 1024; one global layer
per six.  long_500k *runs*: decode against a long KV is linear per step and
5/6 of layers keep only a 1024-token window (see DESIGN.md §Arch-applicability).
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv=16,
    head_dim=128,
    d_ff=21504,
    vocab=262144,
    window=1024,
    local_global=(5, 1),
    act="gelu_glu",
    rope_theta=1e6,
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt",
)
