"""Plain PyTorch version of the decode-attention kernel.

It computes what ``repro_torch.models.attention._reference_attention``
computes for one query position over a cache's valid prefix, reading only
that prefix: scores and softmax in f32 with scale ``D ** -0.5``, the
weighted sum in f32, the output rounded once to q's dtype.  The CPU path
of :mod:`.ops` runs it, and the card's tests hold the kernel to it.  It
keeps a call count, so a run can show that the main path on the card
never took it.
"""

from __future__ import annotations

import torch

__all__ = ["decode_attention", "counts"]

#: calls of the plain version since the last reset
counts = {"decode_attention": 0}


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: int) -> torch.Tensor:
    """q (B, 1, Hq, D), k/v (B, Lmax, Hkv, D) -> (B, 1, Hq, D) in q's
    dtype: q head h attends over positions ``[0, valid)`` of kv head
    ``h // (Hq / Hkv)``."""
    counts["decode_attention"] += 1
    b, _, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, d).float()
    kf = k[:, :valid].float()
    vf = v[:, :valid].float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, kf) * d ** -0.5
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, vf)
    return out.reshape(b, 1, hq, d).to(q.dtype)
