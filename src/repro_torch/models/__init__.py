"""LM stack on PyTorch: layers, attention, the mixture of experts, the
SSM mixers and the transformer of every family (dense, moe, vlm, audio,
ssm, hybrid), with prefill attention on the hand-written Hopper
flash-attention kernels.

The port of ``src/repro/models``.  ``forward`` and ``loss_fn`` are
differentiable (blocked attention has its hand-written backward; every
block recomputes its activations under ``cfg.remat == "full"``).  The
expert-parallel all-to-all path is ``moe.moe_apply_ep`` (a mesh set with
``moe.set_mesh``); ``param_shapes`` and the ``io`` specs give the
dry-run its shapes on the meta device.
"""

from .convert import opt_from_jax, params_from_jax
from .io import batch_specs, cache_specs, input_specs, make_batch, text_len
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
    param_shapes,
    prefill,
)

__all__ = [
    "XLSTMLM", "DenseLM", "EncDecLM", "ZambaLM", "batch_specs",
    "cache_specs", "decode_step", "fill_cache", "forward", "init_cache",
    "init_params", "input_specs", "loss_fn", "make_batch", "moe_apply",
    "moe_capacity", "moe_init", "opt_from_jax", "param_shapes",
    "params_from_jax", "prefill", "text_len",
]
