"""LM stack on PyTorch: layers, attention, the mixture of experts, the
SSM mixers and the transformer of every family (dense, moe, vlm, audio,
ssm, hybrid), with prefill attention on the hand-written Hopper
flash-attention kernels.

The port of ``src/repro/models``.  Blocked attention and training
(ROADMAP Queue 1 item 5), the expert-parallel ``shard_map`` path and the
dry-run's shape specs (item 6) are not ported yet.
"""

from .convert import params_from_jax
from .io import make_batch, text_len
from .moe import moe_apply, moe_capacity, moe_init
from .transformer import (
    XLSTMLM,
    DenseLM,
    EncDecLM,
    ZambaLM,
    decode_step,
    fill_cache,
    forward,
    init_cache,
    init_params,
    loss_fn,
    prefill,
)

__all__ = [
    "XLSTMLM", "DenseLM", "EncDecLM", "ZambaLM", "decode_step",
    "fill_cache", "forward", "init_cache", "init_params", "loss_fn",
    "make_batch", "moe_apply", "moe_capacity", "moe_init",
    "params_from_jax", "prefill", "text_len",
]
