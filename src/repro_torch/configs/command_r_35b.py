"""command-r-35b — GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01; unverified].

Copied unchanged from ``src/repro/configs/command_r_35b.py``.

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000, layernorm,
tied embeddings (command-r ties input/output embeddings).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b", family="dense",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22528, vocab_size=256000, norm="layernorm", tied_embeddings=True,
)
