"""Mixture-of-Experts layer: top-k routing with capacity-bounded,
index-based dispatch.

The port of ``moe_init``, ``moe_capacity`` and ``moe_apply`` of
``src/repro/models/moe.py``, with the same semantics, per batch row:

  1. f32 router softmax, top-k gates, renormalised;
  2. position-in-expert from a stable sort of the flat expert choices
     (rank within each expert's segment);
  3. choices past the capacity are dropped into an extra bucket row (the
     residual path carries them);
  4. tokens gathered into (B, E, C, D), the expert SwiGLU batched over
     the expert dim, each kept choice's output weighted and summed back.

``torch.argsort(..., stable=True)``, ``scatter_add_``, ``scatter_`` and
``gather`` take the place of the reference's ``.at[]`` updates.  The
expert-parallel ``shard_map`` path (``moe_shard="ep"`` / ``"ep_infer"``)
is not ported: ROADMAP Queue 1 item 6.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .layers import Params, dense_init

__all__ = ["moe_init", "moe_apply", "moe_capacity", "moe_route"]


def moe_init(generator: torch.Generator, cfg, dtype) -> Params:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return Params(
        router=dense_init(generator, (d, e), dtype=torch.float32),
        w1=dense_init(generator, (e, d, f), dtype=dtype),
        w3=dense_init(generator, (e, d, f), dtype=dtype),
        w2=dense_init(generator, (e, f, d), dtype=dtype),
    )


def moe_capacity(cfg, seq_len: int) -> int:
    cap = int(seq_len * cfg.experts_per_token * cfg.capacity_factor
              / cfg.n_experts)
    return max(cap, cfg.experts_per_token)


def moe_route(p, cfg, x: torch.Tensor, capacity: int):
    """Routing of x (B, S, D): the renormalised top-k gates (B, S, k), and
    for each flat choice (B, S * k) its expert, whether it is kept, and
    its slot (``expert * capacity + position``, or ``E * capacity``, the
    drop bucket, where it is not kept)."""
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    logits = x.float() @ p["router"].float()
    gates = torch.softmax(logits, dim=-1)                      # (B, S, E)
    topv, topi = torch.topk(gates, k, dim=-1)                  # (B, S, k)
    topv = topv / topv.sum(dim=-1, keepdim=True)               # renormalize

    # position-in-expert by stable sort of flat choices (per batch row)
    ef = topi.reshape(b, s * k)                                # (B, S*k)
    order = torch.argsort(ef, dim=1, stable=True)
    sorted_e = torch.gather(ef, 1, order)
    counts = torch.zeros((b, e), dtype=ef.dtype, device=x.device)
    counts.scatter_add_(1, ef, torch.ones_like(ef))
    starts = counts.cumsum(dim=1) - counts                     # exclusive
    pos_sorted = (torch.arange(s * k, device=x.device)[None, :]
                  - torch.gather(starts, 1, sorted_e))
    pos = torch.empty_like(ef).scatter_(1, order, pos_sorted)

    keep = pos < capacity
    slot = torch.where(keep, ef * capacity + pos,
                       torch.full_like(ef, e * capacity))     # drop bucket
    return topv, ef, keep, slot


def moe_apply(p, cfg, x: torch.Tensor,
              capacity: Optional[int] = None) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D)."""
    if cfg.moe_shard in ("ep", "ep_infer"):
        raise NotImplementedError(
            f"moe_shard={cfg.moe_shard!r} (the expert-parallel shard_map "
            f"path over a mesh) is not ported yet: ROADMAP Queue 1 item 6")
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    capacity = capacity or moe_capacity(cfg, s)
    topv, _, keep, slot = moe_route(p, cfg, x, capacity)

    # dispatch: (B, E*C+1, D) buffer; the last row swallows drops
    token_of_choice = torch.arange(s, device=x.device).repeat_interleave(k)
    idx = slot[..., None].expand(b, s * k, d)
    xin = torch.zeros((b, e * capacity + 1, d), dtype=x.dtype,
                      device=x.device)
    xin.scatter_(1, idx, x[:, token_of_choice])
    xin = xin[:, :-1].reshape(b, e, capacity, d)

    # expert SwiGLU, batched over the expert dim
    h = F.silu(torch.einsum("becd,edf->becf", xin, p["w1"])) * torch.einsum(
        "becd,edf->becf", xin, p["w3"])
    y = torch.einsum("becf,efd->becd", h, p["w2"])             # (B, E, C, D)

    # combine: gather each kept choice's output, weight, sum over k
    y_flat = torch.cat([y.reshape(b, e * capacity, d),
                        torch.zeros((b, 1, d), dtype=y.dtype,
                                    device=y.device)], dim=1)
    w = topv.reshape(b, s * k)[..., None].to(y.dtype) * keep[..., None]
    per_choice = torch.gather(y_flat, 1, idx) * w
    return per_choice.reshape(b, s, k, d).sum(dim=2)
