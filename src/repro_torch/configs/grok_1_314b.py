"""grok-1-314b — 8 experts top-2 MoE [hf:xai-org/grok-1; unverified].

Copied unchanged from ``src/repro/configs/grok_1_314b.py``.

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, MoE 8e top-2.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=32768, vocab_size=131072, n_experts=8, experts_per_token=2,
)
