"""whisper-small [audio] — enc-dec, conv frontend stubbed as frame embeddings.

[arXiv:2212.04356; unverified]  The transformer backbone only: the audio
frontend is a stub; ``input_specs`` provides precomputed frame embeddings.
Full attention both sides -> long_500k skipped (quadratic encoder).
"""
from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,                 # decoder layers
    n_enc_layers=12,
    enc_dec=True,
    dec_ratio=8,                 # dec_len = seq_len // 8 (ASR token ratio)
    d_model=768,
    n_heads=12,
    n_kv=12,
    head_dim=64,
    d_ff=3072,
    vocab=51865,
    act="gelu",
    norm="layernorm",
    skip_shapes=("long_500k",),
    skip_reason="pure full attention (enc-dec); 500k quadratic encoder "
                "prefill is out of roofline scope — see DESIGN.md",
    source="arXiv:2212.04356",
)
