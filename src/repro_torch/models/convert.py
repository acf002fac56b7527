"""Carry the reference's parameters into the port's model.

``params_from_jax`` takes the JAX package's layer-stacked parameter tree,
already turned into nested dicts of numpy arrays by the caller (this
module never imports jax), and builds the port's :class:`DenseLM` (dense,
moe, vlm) or :class:`EncDecLM` (audio) with the same weights in the same
``(in, out)`` orientation.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .layers import Params
from .transformer import (
    DecoderBlock, DenseBlock, DenseLM, EncDecLM, EncoderBlock, _check_family,
)

__all__ = ["params_from_jax"]


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16: exact via f32
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _params(tree: dict, device: torch.device, layer=None) -> Params:
    return Params(**{name: _tensor(a if layer is None else a[layer], device)
                     for name, a in tree.items()})


def _blocks(block, stacked: dict, n: int, device: torch.device) -> list:
    """``n`` blocks of class ``block``, each taking its layer of every
    group of ``stacked`` (a tree whose arrays have a leading L axis)."""
    got = np.asarray(stacked["attn"]["wq"]).shape[0]
    if got != n:
        raise ValueError(f"tree has {got} layers, cfg {n}")
    return [block(**{name: _params(group, device, i)
                     for name, group in stacked.items()})
            for i in range(n)]


def params_from_jax(cfg, tree: dict, device=None):
    """``tree``: for dense, moe and vlm ``{"embed", "layers": {"ln1",
    "attn": {wq, wk, wv, wo}, "ln2", "mlp": {w1, w3, w2} or "moe":
    {router, w1, w3, w2}}, "final_norm", "lm_head"}`` (``lm_head`` absent
    when the embeddings are tied); for audio ``{"embed", "encoder":
    {"ln1", "attn", "ln2", "mlp": {w1, w2}}, "enc_norm", "decoder":
    {"ln1", "attn", "lnx", "xattn", "ln2", "mlp"}, "final_norm"}``; of
    numpy arrays, each of ``layers``, ``encoder`` and ``decoder`` with a
    leading L axis."""
    _check_family(cfg)
    dev = resolve_device(device)
    if cfg.family == "audio":
        return EncDecLM(
            _tensor(tree["embed"], dev),
            _blocks(EncoderBlock, tree["encoder"], cfg.encoder_layers, dev),
            _params(tree["enc_norm"], dev),
            _blocks(DecoderBlock, tree["decoder"], cfg.n_layers, dev),
            _params(tree["final_norm"], dev))
    head = tree.get("lm_head")
    return DenseLM(_tensor(tree["embed"], dev),
                   _blocks(DenseBlock, tree["layers"], cfg.n_layers, dev),
                   _params(tree["final_norm"], dev),
                   None if head is None else _tensor(head, dev))
