"""Plain-torch reference of the training step the benchmark runs: the
dense decoder of :mod:`.dense_lm` in float32, next-token cross entropy
averaged over every position but each row's last, its gradients by
autograd (each block's activations recomputed in the backward, so that
the full-size model fits), and AdamW as the configuration states it:
the gradients clipped to a global norm, moments ``m`` and ``v`` with
bias correction, decoupled weight decay on every weight, and a learning
rate that warms up linearly over ``warmup_steps`` and then follows a
cosine down to ``min_lr_frac`` of its peak at ``total_steps``.

It reports what the check compares: each step's loss, each weight's
gradient norm at the first step (after clipping: what the optimizer
takes), and how far each weight moved over the steps.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .dense_lm import block, exact_f32, supported, unembed

__all__ = ["lr_at", "loss", "train_steps", "leaves"]


def leaves(weights: dict) -> dict:
    """``{name: tensor}`` of every weight, in a fixed order of names."""
    out = {"embed": weights["embed"]}
    for i, w in enumerate(weights["layers"]):
        for n, t in w.items():
            if isinstance(t, dict):
                out.update({f"layers.{i}.{n}.{k}": v for k, v in t.items()})
            else:
                out[f"layers.{i}.{n}"] = t
    out.update({f"final_norm.{k}": v
                for k, v in weights["final_norm"].items()})
    if weights["lm_head"] is not None:
        out["lm_head"] = weights["lm_head"]
    return out


def _rebuild(like: dict, flat: dict) -> dict:
    """``like``'s structure with the tensors of ``flat`` (named as
    :func:`leaves` names them)."""
    layers = []
    for i, w in enumerate(like["layers"]):
        layers.append({n: ({k: flat[f"layers.{i}.{n}.{k}"] for k in t}
                           if isinstance(t, dict) else flat[f"layers.{i}.{n}"])
                       for n, t in w.items()})
    return {"embed": flat["embed"], "layers": layers,
            "final_norm": {k: flat[f"final_norm.{k}"]
                           for k in like["final_norm"]},
            "lm_head": flat.get("lm_head")}


def lr_at(opt: dict, step: int) -> float:
    lr, warm = opt["lr"], opt["warmup_steps"]
    if step < warm:
        return lr * step / max(warm, 1)
    t = min(max((step - warm) / max(opt["total_steps"] - warm, 1), 0.0), 1.0)
    lo = opt["min_lr_frac"] * lr
    return lo + (lr - lo) * 0.5 * (1 + math.cos(math.pi * t))


def loss(cfg: dict, weights: dict, tokens: torch.Tensor,
         quant: Optional[str] = None) -> torch.Tensor:
    """Mean next-token cross entropy of ``tokens`` (B, S), float32, with
    every block recomputed in the backward."""
    x = weights["embed"][tokens].float()
    pos = torch.arange(tokens.shape[1], device=tokens.device)[None]
    for w in weights["layers"]:
        x = checkpoint(lambda x, w=w: block(cfg, w, x, pos, quant)[0], x,
                       use_reentrant=False)
    logits = unembed(cfg, weights, x[:, :-1], quant)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1))


def train_steps(cfg: dict, opt: dict, weights: dict, batches: list,
                quant: Optional[str] = None) -> dict:
    """AdamW steps from ``weights`` (the benchmark's, left untouched), one
    on each of ``batches``.  Returns ``{"losses": [...], "first_grad":
    {name: norm}, "change": {name: norm}}``: the gradient norms of the
    first step after clipping, the distance each weight moved over all
    the steps."""
    supported(cfg)
    start = {n: t.detach() for n, t in leaves(weights).items()}
    params = {n: t.float().clone().requires_grad_(True)
              for n, t in start.items()}
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    b1, b2 = opt["betas"]
    losses, first = [], {}
    with exact_f32():
        for step, tokens in enumerate(batches, start=1):
            w = _rebuild(weights, params)
            value = loss(cfg, w, tokens, quant)
            grads = torch.autograd.grad(value, list(params.values()))
            losses.append(float(value.detach()))
            with torch.no_grad():
                gnorm = torch.sqrt(sum((g * g).sum() for g in grads))
                scale = min(1.0, opt["clip_norm"] / (float(gnorm) + 1e-9))
                lr = lr_at(opt, step)
                for (n, p), g in zip(params.items(), grads):
                    g = g * scale
                    if step == 1:
                        first[n] = float(g.norm())
                    m[n].mul_(b1).add_((1 - b1) * g)
                    v[n].mul_(b2).add_((1 - b2) * g * g)
                    upd = (m[n] / (1 - b1 ** step)) / (
                        torch.sqrt(v[n] / (1 - b2 ** step)) + opt["eps"])
                    p.sub_(lr * (upd + opt["weight_decay"] * p))
            del grads, w
        with torch.no_grad():
            change = {n: float((p - start[n].float()).norm())
                      for n, p in params.items()}
    return {"losses": losses, "first_grad": first, "change": change}
