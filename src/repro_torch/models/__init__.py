"""LM stack on PyTorch: layers, attention and the dense-family
transformer, with prefill attention on the hand-written Hopper
flash-attention kernel.

The port of ``src/repro/models`` for the dense family.  MoE, the SSM
mixers, the other families, ``loss_fn`` and the dry-run's shape specs
are not ported yet (ROADMAP Queue 1 items 8-10, 13).
"""

from .convert import params_from_jax
from .io import make_batch, text_len
from .transformer import (
    DenseLM,
    decode_step,
    fill_cache,
    forward,
    init_cache,
    init_params,
    prefill,
)

__all__ = [
    "DenseLM", "decode_step", "fill_cache", "forward", "init_cache",
    "init_params", "make_batch", "params_from_jax", "prefill", "text_len",
]
