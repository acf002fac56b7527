"""LM stack on PyTorch: layers, attention, the mixture of experts and the
transformer of the dense, moe, vlm and audio families, with prefill
attention on the hand-written Hopper flash-attention kernels.

The port of ``src/repro/models``.  The SSM mixers and the ssm and hybrid
families (ROADMAP Queue 1 item 4), ``loss_fn`` and blocked attention
(item 5), the expert-parallel ``shard_map`` path and the dry-run's shape
specs (item 6) are not ported yet.
"""

from .convert import params_from_jax
from .io import make_batch, text_len
from .moe import moe_apply, moe_capacity, moe_init
from .transformer import (
    DenseLM,
    EncDecLM,
    decode_step,
    fill_cache,
    forward,
    init_cache,
    init_params,
    prefill,
)

__all__ = [
    "DenseLM", "EncDecLM", "decode_step", "fill_cache", "forward",
    "init_cache", "init_params", "make_batch", "moe_apply", "moe_capacity",
    "moe_init", "params_from_jax", "prefill", "text_len",
]
