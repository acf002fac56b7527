"""codeqwen1.5-7b — qwen1.5-arch [hf:Qwen/CodeQwen1.5-7B; hf].

Copied unchanged from ``src/repro/configs/codeqwen15_7b.py``.

32L d_model=4096 32H (GQA kv=32 = MHA) d_ff=13440 vocab=92416.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=13440, vocab_size=92416,
)
