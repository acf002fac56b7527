"""Train / prefill / decode step functions.

The port of ``src/repro/training/train_step.py``.  ``make_steps(cfg,
opt_cfg)`` returns closures over a model (an ``nn.Module`` of weights,
updated in place) in place of the reference's functions of a params
pytree: ``jax.value_and_grad`` becomes ``torch.autograd.grad`` of
``loss_fn``, the microbatch ``lax.scan`` a Python loop over slices along
axis 0 whose gradients are accumulated in f32 and averaged, as the
reference's.  Optional int8 gradient compression quantizes the
gradients in blocks before the update (see ``training/compression.py``),
over the reference's layer-stacked leaves (:func:`_compress_round_trip`).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models import decode_step as model_decode
from ..models import forward, loss_fn
from .compression import compress_tree, decompress_tree
from .optimizer import OptConfig, adamw_init, adamw_update

__all__ = ["make_steps", "TrainStepConfig"]


def _compress_round_trip(grads: dict) -> dict:
    """``grads`` through int8 compression and back, blocked as the
    reference blocks them: its leaves stack a parameter of every layer
    (the port's names that differ only in their integer parts, stacked in
    index order), and a block of 256 elements may straddle two layers
    where a layer's tensor is not a whole number of blocks."""
    stacks: dict = {}
    for name in grads:
        parts = name.split(".")
        key = ".".join(p for p in parts if not p.isdigit())
        index = tuple(int(p) for p in parts if p.isdigit())
        stacks.setdefault(key, []).append((index, name))
    for members in stacks.values():
        members.sort()
    back = decompress_tree(compress_tree(
        {key: torch.stack([grads[n] for _, n in members])
         for key, members in stacks.items()}))
    out = {}
    for key, members in stacks.items():
        out.update(zip((n for _, n in members), back[key].unbind()))
    return {n: out[n] for n in grads}


def make_steps(cfg, opt_cfg: Optional[OptConfig] = None, *,
               microbatches: int = 1, compress_grads: bool = False) -> dict:
    """Returns a dict of ``train_step(model, opt, batch) -> (model, opt,
    metrics)`` (the weights switched to ``requires_grad`` and updated in
    place), ``prefill_step(model, batch)``, ``decode_step(model, cache,
    tokens)`` and ``init_opt(model)``."""
    opt_cfg = opt_cfg or OptConfig()

    def grads_of(params: dict, model, batch: dict):
        loss, metrics = loss_fn(cfg, model, batch)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        # a weight the loss does not reach gets zeros, as jax.grad gives
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(params.items(), grads)}
        return loss.detach(), metrics, grads

    def train_step(model, opt: dict, batch: dict):
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        if microbatches > 1:
            mb = next(iter(batch.values())).shape[0] // microbatches
            acc = {n: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
                   for n, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            for i in range(microbatches):
                mb_batch = {k: v[i * mb:(i + 1) * mb]
                            for k, v in batch.items()}
                mb_loss, _, grads = grads_of(params, model, mb_batch)
                for n, g in grads.items():
                    acc[n] += g
                loss = loss + mb_loss
                del grads
            grads = {n: g / microbatches for n, g in acc.items()}
            loss = loss / microbatches
            metrics = {"loss": loss, "perplexity": torch.exp(loss)}
        else:
            _, metrics, grads = grads_of(params, model, batch)
            metrics = {k: v.detach() for k, v in metrics.items()}
        if compress_grads:
            grads = _compress_round_trip(grads)
        _, opt, opt_metrics = adamw_update(opt_cfg, params, grads, opt)
        return model, opt, {**metrics, **opt_metrics}

    @torch.no_grad()
    def prefill_step(model, batch: dict) -> torch.Tensor:
        # serving prefill: only the next-token distribution is needed —
        # unembed just the last position (a large-vocab win)
        return forward(cfg, model, batch, last_only=True)

    def decode(model, cache: dict, tokens: torch.Tensor):
        return model_decode(cfg, model, cache, tokens)

    return {
        "train_step": train_step,
        "prefill_step": prefill_step,
        "decode_step": decode,
        "init_opt": lambda model: adamw_init(dict(model.named_parameters())),
    }


TrainStepConfig = OptConfig  # re-export alias used by launch configs
