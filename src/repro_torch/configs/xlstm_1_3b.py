"""xlstm-1.3b — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

Copied unchanged from ``src/repro/configs/xlstm_1_3b.py``.

48L d_model=2048 4H (GQA kv=4) d_ff=0 vocab=50304.  d_ff=0: xLSTM blocks
integrate their own 2x up-projection (no separate FFN).  One sLSTM block per
8 blocks (the xLSTM[7:1] recipe).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, head_dim=512,
    d_ff=0, vocab_size=50304, slstm_every=8, ssm_chunk=256,
)
