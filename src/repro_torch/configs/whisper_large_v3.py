"""whisper-large-v3 — enc-dec, conv frontend (stub) [arXiv:2212.04356].

Copied unchanged from ``src/repro/configs/whisper_large_v3.py``.

32L (decoder) d_model=1280 20H d_ff=5120 vocab=51866; 32 encoder layers over
1500 post-conv audio frames (30 s).  The conv frontend is a stub: input_specs
provides precomputed frame embeddings (B, 1500, d_model).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, head_dim=64,
    d_ff=5120, vocab_size=51866, norm="layernorm",
    encoder_layers=32, encoder_seq=1500, frontend="audio",
)
