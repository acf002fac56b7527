"""Carry the reference's parameters into the port's model.

``params_from_jax`` takes the JAX package's layer-stacked parameter tree,
already turned into nested dicts of numpy arrays by the caller (this
module never imports jax), and builds the port's :class:`DenseLM` (dense,
moe, vlm), :class:`EncDecLM` (audio), :class:`XLSTMLM` (ssm) or
:class:`ZambaLM` (hybrid) with the same weights in the same ``(in,
out)`` orientation.  ``opt_from_jax`` carries the reference's AdamW state
(``repro.training.optimizer.adamw_init``'s tree) across by the same
mapping, keyed by the port's parameter names.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from . import ssm
from .layers import Params
from .transformer import (
    DecoderBlock, DenseBlock, DenseLM, EncDecLM, EncoderBlock, XLSTMLM,
    ZambaLM, xlstm_layout, zamba_layout,
)

__all__ = ["opt_from_jax", "params_from_jax"]


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16: exact via f32
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _params(tree: dict, device: torch.device, index=(), cls=Params):
    """``cls`` of the tree's arrays, each indexed by ``index`` (its
    position on the stacked leading axes); a nested dict becomes a
    nested :class:`Params`."""
    return cls(**{name: (_params(a, device, index) if isinstance(a, dict)
                         else _tensor(np.asarray(a)[index], device))
                  for name, a in tree.items()})


def _stacked(tree: dict, want: tuple) -> None:
    """Check the tree's leading (stacked) axes against ``cfg``'s."""
    leaf = tree
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    got = np.asarray(leaf).shape[:len(want)]
    if got != want:
        raise ValueError(f"tree has {got} stacked blocks, cfg {want}")


def _blocks(block, stacked: dict, n: int, device: torch.device) -> list:
    """``n`` blocks of class ``block``, each taking its layer of every
    group of ``stacked`` (a tree whose arrays have a leading L axis)."""
    _stacked(stacked, (n,))
    return [block(**{name: _params(group, device, i)
                     for name, group in stacked.items()})
            for i in range(n)]


def _ssm_blocks(cls, stacked: dict, n_sb: int, per: int,
                device: torch.device) -> list:
    """(n_sb, per) blocks of ``cls`` from a tree stacked on both axes."""
    _stacked(stacked, (n_sb, per))
    return [[_params(stacked, device, (sb, i), cls) for i in range(per)]
            for sb in range(n_sb)]


def params_from_jax(cfg, tree: dict, device=None):
    """``tree``, of numpy arrays:

    * dense, moe, vlm: ``{"embed", "layers": {"ln1", "attn": {wq, wk, wv,
      wo}, "ln2", "mlp": {w1, w3, w2} or "moe": {router, w1, w3, w2}},
      "final_norm", "lm_head"}`` (``lm_head`` absent when the embeddings
      are tied), ``layers`` with a leading L axis;
    * audio: ``{"embed", "encoder": {"ln1", "attn", "ln2", "mlp": {w1,
      w2}}, "enc_norm", "decoder": {"ln1", "attn", "lnx", "xattn", "ln2",
      "mlp"}, "final_norm"}``, the stacks with a leading L axis;
    * ssm: ``{"embed", "mblocks", "sblocks", "final_norm", "lm_head"}``,
      ``mblocks`` (mLSTM) stacked (n_sb, m_per, ...) and ``sblocks``
      (sLSTM) (n_sb, ...);
    * hybrid: ``{"embed", "mamba_sb", "mamba_tail", "shared_attn",
      "final_norm", "lm_head"}``, ``mamba_sb`` stacked (n_sb, per, ...),
      ``mamba_tail`` (tail, ...) and ``shared_attn`` (``{"ln1", "attn",
      "ln2", "mlp"}``) one block, unstacked."""
    dev = resolve_device(device)
    embed = _tensor(tree["embed"], dev)
    final_norm = _params(tree["final_norm"], dev)
    if cfg.family == "audio":
        return EncDecLM(
            embed,
            _blocks(EncoderBlock, tree["encoder"], cfg.encoder_layers, dev),
            _params(tree["enc_norm"], dev),
            _blocks(DecoderBlock, tree["decoder"], cfg.n_layers, dev),
            final_norm)
    head = tree.get("lm_head")
    head = None if head is None else _tensor(head, dev)
    if cfg.family == "ssm":
        n_sb, m_per = xlstm_layout(cfg)
        _stacked(tree["sblocks"], (n_sb,))
        return XLSTMLM(
            embed,
            _ssm_blocks(ssm.MLSTMBlock, tree["mblocks"], n_sb, m_per, dev),
            [_params(tree["sblocks"], dev, sb, ssm.SLSTMBlock)
             for sb in range(n_sb)],
            final_norm, head)
    if cfg.family == "hybrid":
        n_sb, per, tail = zamba_layout(cfg)
        _stacked(tree["mamba_tail"], (tail,))
        return ZambaLM(
            embed,
            _ssm_blocks(ssm.Mamba2Block, tree["mamba_sb"], n_sb, per, dev),
            [_params(tree["mamba_tail"], dev, i, ssm.Mamba2Block)
             for i in range(tail)],
            DenseBlock(**{name: _params(group, dev)
                          for name, group in tree["shared_attn"].items()}),
            final_norm, head)
    return DenseLM(embed, _blocks(DenseBlock, tree["layers"], cfg.n_layers,
                                  dev),
                   final_norm, head)


def opt_from_jax(cfg, opt: dict, device=None) -> dict:
    """The reference's optimizer state ``{"m", "v": trees shaped as the
    params, "step": scalar}``, of numpy arrays, as the port's
    (:func:`repro_torch.training.optimizer.adamw_init`'s layout): ``"m"``
    and ``"v"`` keyed by the names of the model's ``named_parameters``,
    ``"step"`` a 0-d int32 tensor."""
    dev = resolve_device(device)
    out = {name: {n: t.detach() for n, t in
                  params_from_jax(cfg, opt[name], dev).named_parameters()}
           for name in ("m", "v")}
    out["step"] = torch.tensor(int(np.asarray(opt["step"])),
                               dtype=torch.int32, device=dev)
    return out
