"""llava-next-mistral-7b — anyres tiling [hf:llava-hf/llava-v1.6-mistral-7b-hf].

Copied unchanged from ``src/repro/configs/llava_next_mistral_7b.py``.

Mistral-7B backbone: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.
The vision frontend is a stub: input_specs provides precomputed anyres patch
embeddings (B, n_patches, d_model); n_patches=1152 (base 576 + one 576 tile).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000, frontend="vlm", n_patches=1152,
)
