"""Plain PyTorch version of the flash-attention kernel.

The port's counterpart of ``src/repro/kernels/flash_attention``.  It has
the semantics of the TPU kernel (``flash_attention.py:_kernel``), not
those of the reference's oracle ``ref.gqa_attention``: a row that sees no
column (causal with Lq > Lk) comes out 0 where the oracle gives NaN.  The
CPU path of :mod:`.ops` runs it, and ``chip_smoke.py`` holds the CUDA
kernel against it on the card.  It keeps a call count, so a run can show
that the main path on the card never took it.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["flash_attention", "counts"]

#: calls of the plain version since the last reset
counts = {"flash_attention": 0}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Hq, Lq, D), k/v (B, Hkv, Lk, D) -> (B, Hq, Lq, D) in q's dtype.

    Scores, softmax and the weighted sum are f32.  q head h reads kv head
    ``h // (Hq // Hkv)``.  Row r sees column c when, if ``causal``,
    ``c <= r + Lk - Lq`` (the mask is aligned to the end of the kv
    sequence); a row that sees none gives 0."""
    counts["flash_attention"] += 1
    hq, lq, d = q.shape[1], q.shape[2], q.shape[3]
    hkv, lk = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = d ** -0.5
    if lk == 0:                 # no column at all: every row gives 0
        return q.new_zeros(q.shape)
    group = hq // hkv
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * sm_scale
    if causal:
        rows = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
        visible = rows >= torch.arange(lk, device=q.device)[None, :]
        s = s.masked_fill(~visible, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    # the kernel's guards: a row with no visible column keeps m = -inf,
    # its p is 0 everywhere and its denominator 1
    m = torch.where(m == float("-inf"), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0, torch.ones_like(l), l)
    return (torch.matmul(p, vf) / l).to(q.dtype)
