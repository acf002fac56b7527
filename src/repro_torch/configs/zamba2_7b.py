"""zamba2-7b — Mamba2 + shared attn blocks [arXiv:2411.15242; unverified].

Copied unchanged from ``src/repro/configs/zamba2_7b.py``.

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64.
One *shared* attention(+MLP) block applied every 6 Mamba2 blocks (the
Zamba2 shared-block scheme; we share plain weights, omitting the per-use
LoRA deltas — see DESIGN.md).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336, vocab_size=32000, ssm_state=64, attn_every=6, ssm_chunk=256,
)
