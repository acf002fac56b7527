"""stablelm-1.6b [hf:stabilityai/stablelm-2-1_6b; unverified].

Copied unchanged from ``src/repro/configs/stablelm_1_6b.py``.

24L d_model=2048 32H (GQA kv=32 = MHA) d_ff=5632 vocab=100352, layernorm.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=5632, vocab_size=100352, norm="layernorm",
)
