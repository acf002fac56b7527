"""AdamW with global-norm clipping and a warmup-cosine schedule.

The port of ``src/repro/training/optimizer.py``, on dicts of tensors
keyed by parameter name (``dict(model.named_parameters())``) in place of
pytrees.  Moments are kept in f32 whatever the parameter dtype (bf16
training); each update is computed in f32 and cast back once a step —
the reference's mixed-precision recipe.  The reference returns new
arrays and its trainer donates the old ones to ``jax.jit``; here
:func:`adamw_update` writes the parameters and moments in place and
returns them.  The step counter, the learning rate and the norm stay on
the device: an update makes no host synchronisation.  Parameters placed
as DTensors (``repro_torch.sharding.place``) get moments of the same
placement, and the update runs on each rank's shards; the global norm
sums the shards' squares across the mesh.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["OptConfig", "adamw_init", "adamw_update", "global_norm",
           "lr_at"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def adamw_init(params: dict) -> dict:
    """f32 zero moments beside each parameter (a DTensor's placed as it
    is), and a 0-d int32 step."""
    device = next(iter(params.values())).device if params else None
    return {
        "m": {n: torch.zeros_like(p, dtype=torch.float32,
                                  memory_format=torch.contiguous_format)
              for n, p in params.items()},
        "v": {n: torch.zeros_like(p, dtype=torch.float32,
                                  memory_format=torch.contiguous_format)
              for n, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def lr_at(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then a cosine decay to
    ``min_lr_frac * lr`` at ``total_steps``; ``step`` an int or a tensor,
    the result an f32 tensor."""
    step = torch.as_tensor(step).float()
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    t = torch.clip((step - cfg.warmup_steps)
                   / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac * cfg.lr + (1 - cfg.min_lr_frac) * cfg.lr * 0.5 * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tensors: dict) -> torch.Tensor:
    """The f32 L2 norm of every tensor together."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tensors.values()))


@torch.no_grad()
def adamw_update(cfg: OptConfig, params: dict, grads: dict, opt: dict):
    """One AdamW step; ``grads`` keyed as ``params``.  Writes the
    parameters and ``opt``'s moments and step in place and returns
    (params, opt, {"grad_norm", "lr"}), as the reference returns its new
    trees; the norm reported is the one before clipping."""
    step = opt["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.betas
    lr = lr_at(cfg, step)
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for name, p in params.items():
        g = grads[name].float() * scale
        m, v = opt["m"][name], opt["v"][name]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        p32 = p.float()
        delta = delta + cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)
    opt["step"] = step
    return params, opt, {"grad_norm": gnorm, "lr": lr}
