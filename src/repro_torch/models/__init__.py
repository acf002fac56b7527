"""LM stack on PyTorch: layers, attention, the mixture of experts, the
SSM mixers and the transformer of every family (dense, moe, vlm, audio,
ssm, hybrid), with prefill attention on the hand-written Hopper
flash-attention kernels.

The port of ``src/repro/models``.  ``forward`` and ``loss_fn`` are
differentiable (blocked attention has its hand-written backward; every
block recomputes its activations under ``cfg.remat == "full"``); the
expert-parallel ``shard_map`` path and the dry-run's shape specs (ROADMAP
Queue 1 item 6) are not ported yet.
"""

from .convert import opt_from_jax, params_from_jax
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
    "make_batch", "moe_apply", "moe_capacity", "moe_init", "opt_from_jax",
    "params_from_jax", "prefill", "text_len",
]
