"""mamba2-370m [ssm] — SSD (state-space duality), attention-free.

[arXiv:2405.21060; unverified]  Constant-size recurrent state: all four
shapes run, including long_500k.
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,                   # attention-free
    n_kv=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    conv_kernel=4,
    tie_embeddings=True,
    norm="rmsnorm",
    source="arXiv:2405.21060",
)
