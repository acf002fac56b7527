"""Carry the reference's parameters into the port's model.

``params_from_jax`` takes the JAX package's layer-stacked parameter tree,
already turned into nested dicts of numpy arrays by the caller (this
module never imports jax), and builds the port's :class:`DenseLM` with
the same weights in the same ``(in, out)`` orientation.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .layers import Params
from .transformer import DenseBlock, DenseLM, _check_family

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


def params_from_jax(cfg, tree: dict, device=None) -> DenseLM:
    """``tree``: ``{"embed", "layers": {"ln1", "attn": {wq, wk, wv, wo},
    "ln2", "mlp": {w1, w3, w2}}, "final_norm", "lm_head"}`` of numpy
    arrays, each of ``layers`` with a leading L axis (``lm_head`` absent
    when the embeddings are tied)."""
    _check_family(cfg)
    dev = resolve_device(device)
    stacked = tree["layers"]
    n = np.asarray(stacked["attn"]["wq"]).shape[0]
    if n != cfg.n_layers:
        raise ValueError(f"tree has {n} layers, cfg {cfg.n_layers}")
    layers = [DenseBlock(_params(stacked["ln1"], dev, i),
                         _params(stacked["attn"], dev, i),
                         _params(stacked["ln2"], dev, i),
                         _params(stacked["mlp"], dev, i))
              for i in range(n)]
    head = tree.get("lm_head")
    return DenseLM(_tensor(tree["embed"], dev), layers,
                   _params(tree["final_norm"], dev),
                   None if head is None else _tensor(head, dev))
