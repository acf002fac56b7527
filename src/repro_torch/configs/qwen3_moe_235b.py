"""qwen3-moe-235b-a22b — 128 experts top-8 [hf:Qwen/Qwen3-235B-A22B].

Copied from ``src/repro/configs/qwen3_moe_235b.py``; only the source on
the first line differs: the reference's names hf:Qwen/Qwen3-30B-A3B,
whose dimensions are not these.

94L d_model=4096 64H (GQA kv=4) d_ff=1536 (per expert) vocab=151936.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab_size=151936, n_experts=128, experts_per_token=8,
)
