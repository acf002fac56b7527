"""Blocked (flash-style) attention in plain PyTorch with a hand-written
backward.

The port of ``src/repro/models/blocked_attention.py``: an online softmax
over KV blocks (a Python loop in place of ``lax.scan``) that returns the
logsumexp, and a ``torch.autograd.Function`` in place of the reference's
``jax.custom_vjp`` whose backward recomputes each block's probabilities
from that logsumexp, so training keeps O(S·d) activations a layer rather
than the O(S²) scores of the reference attention.

The casts are the reference's: scores and every accumulation in f32
(``preferred_element_type=float32`` there; here the operands are upcast
to f32, which gives the same values, since a bf16 product is exact in
f32), p rounded to the value dtype before P.V, ds rounded to the operand
dtype before dq and dk.  The last block is a shorter slice where the
reference zero-pads it; the padded columns are masked there, so the
values are the same.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["blocked_attention"]

_NEG_INF = float("-inf")


def _prep(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """q (B, Sq, Hq, hd) -> (B, Hkv, G, Sq, hd); k, v (B, Sk, Hkv, hd) ->
    (B, Hkv, Sk, hd)."""
    b, sq, hq, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, hd).permute(0, 2, 3, 1, 4)
    return qg, k.transpose(1, 2), v.transpose(1, 2)


def _mask_for(lo: int, hi: int, sq: int, sk_real: int, causal: bool,
              kv_valid: Optional[int], device) -> torch.Tensor:
    """(Sq, hi - lo) bool mask for keys lo..hi (True = attend)."""
    kpos = torch.arange(lo, hi, device=device)[None, :]
    mask = kpos < (sk_real if kv_valid is None else kv_valid)
    if causal:
        qpos = torch.arange(sq, device=device)[:, None] + (sk_real - sq)
        mask = mask & (qpos >= kpos)
    return mask


def _scores(qg: torch.Tensor, kx: torch.Tensor, scale: float) -> torch.Tensor:
    """(B, H, G, Sq, hd) x (B, H, K, hd) -> (B, H, G, Sq, K) f32 scores."""
    b, h, g, sq, hd = qg.shape
    s = qg.float().reshape(b, h, g * sq, hd) @ kx.float().transpose(-1, -2)
    return s.reshape(b, h, g, sq, -1) * scale


def _blocks(sk: int, block_k: int):
    return [(lo, min(lo + block_k, sk)) for lo in range(0, sk, block_k)]


def _forward(q, k, v, causal, block_k, kv_valid):
    qg, kt, vt = _prep(q, k, v)
    b, h, g, sq, hd = qg.shape
    sk = kt.shape[2]
    scale = hd ** -0.5
    m = torch.full((b, h, g, sq), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, g, sq, hd), dtype=torch.float32,
                      device=q.device)
    for lo, hi in _blocks(sk, block_k):
        kx, vx = kt[:, :, lo:hi], vt[:, :, lo:hi]
        mask = _mask_for(lo, hi, sq, sk, causal, kv_valid, q.device)
        s = _scores(qg, kx, scale).masked_fill(~mask, _NEG_INF)
        m2 = torch.maximum(m, s.amax(dim=-1))
        msafe = torch.where(torch.isinf(m2), 0.0, m2)
        p = torch.where(mask, torch.exp(s - msafe[..., None]), 0.0)
        alpha = torch.where(torch.isinf(m), 0.0, torch.exp(m - msafe))
        l = l * alpha + p.sum(dim=-1)
        pv = p.to(vx.dtype).float().reshape(b, h, g * sq, hi - lo) \
            @ vx.float()
        acc = acc * alpha[..., None] + pv.reshape(b, h, g, sq, hd)
        m = m2
    denom = torch.where(l == 0.0, 1.0, l)
    out = acc / denom[..., None]
    lse = torch.where(l == 0.0, 0.0, m + torch.log(denom))
    return out, lse


def _backward(q, k, v, out, lse, dout, causal, block_k, kv_valid):
    qg, kt, vt = _prep(q, k, v)
    b, h, g, sq, hd = qg.shape
    sk = kt.shape[2]
    scale = hd ** -0.5
    do = dout.float()
    drow = (do * out.float()).sum(dim=-1)                     # (b,h,g,q)
    do_rows = do.reshape(b, h, g * sq, hd)
    dq = torch.zeros((b, h, g * sq, hd), dtype=torch.float32,
                     device=q.device)
    dks, dvs = [], []
    for lo, hi in _blocks(sk, block_k):
        kx, vx = kt[:, :, lo:hi], vt[:, :, lo:hi]
        mask = _mask_for(lo, hi, sq, sk, causal, kv_valid, q.device)
        p = torch.where(mask, torch.exp(_scores(qg, kx, scale)
                                        - lse[..., None]), 0.0)
        p_rows = p.reshape(b, h, g * sq, hi - lo)
        dvs.append(p_rows.transpose(-1, -2) @ do_rows)        # (b,h,k,d)
        dp = (do_rows @ vx.float().transpose(-1, -2)).reshape(p.shape)
        ds = (p * (dp - drow[..., None]) * scale).reshape(p_rows.shape)
        dq = dq + ds.to(kx.dtype).float() @ kx.float()
        dks.append(ds.to(qg.dtype).float().transpose(-1, -2)
                   @ qg.float().reshape(b, h, g * sq, hd))
    dk = torch.cat(dks, dim=2).transpose(1, 2)
    dv = torch.cat(dvs, dim=2).transpose(1, 2)
    dq = dq.reshape(b, h, g, sq, hd).permute(0, 3, 1, 2, 4).reshape(q.shape)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _BlockedCore(torch.autograd.Function):
    """q, k, v -> the f32 output (B, Hkv, G, Sq, hd); saves q, k, v, the
    output and the logsumexp, as the reference's ``_blocked_fwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_k, kv_valid):
        out, lse = _forward(q, k, v, causal, block_k, kv_valid)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, block_k, kv_valid)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, lse, dout, *ctx.args)
        return dq, dk, dv, None, None, None


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, kv_valid: Optional[int] = None,
                      block_k: int = 1024) -> torch.Tensor:
    """q: (B, Sq, Hq, hd); k/v: (B, Sk, Hkv, hd) -> (B, Sq, Hq, hd) in q's
    dtype.  ``kv_valid``: the valid prefix length of k/v, or None.  A row
    that sees no key gives 0 (logsumexp 0), as the reference's."""
    b, sq, hq, hd = q.shape
    block_k = min(block_k, k.shape[1])
    out = _BlockedCore.apply(q, k, v, causal, block_k, kv_valid)
    # (b, hkv, g, sq, hd) -> (b, sq, hq, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, hd).to(q.dtype)
