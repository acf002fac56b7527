"""GQA attention: init, prefill forward (self, encoder and cross
attention), cached decode.

The port of ``src/repro/models/attention.py``.  Activations are
(B, S, H, D), as in the reference.  ``cfg.attention_impl`` picks the
prefill path:

* ``"pallas"`` runs the hand-written Hopper flash-attention kernel
  (:func:`repro_torch.kernels.flash_attention.ops.flash_attention`; its
  plain version on CPU tensors).  It has no backward, as in the
  reference, and raises under autograd;
* ``"reference"`` runs the plain einsum path, :func:`_reference_attention`;
* ``"blocked"`` runs the online-softmax loop over KV blocks with its
  hand-written backward
  (:func:`repro_torch.models.blocked_attention.blocked_attention`), the
  reference's ``custom_vjp`` training attention.

Decode stays on the plain path, as in the reference.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels.flash_attention import ops as flash_ops
from .blocked_attention import blocked_attention
from .layers import Params, dense_init, rope

__all__ = ["attn_init", "attention", "decode_attention", "init_layer_cache"]


def attn_init(generator: torch.Generator, cfg, dtype,
              d_in: Optional[int] = None) -> Params:
    d = d_in or cfg.d_model
    hd, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    return Params(
        wq=dense_init(generator, (d, hq * hd), dtype=dtype),
        wk=dense_init(generator, (d, hkv * hd), dtype=dtype),
        wv=dense_init(generator, (d, hkv * hd), dtype=dtype),
        wo=dense_init(generator, (hq * hd, d), dtype=dtype),
    )


def _split_heads(x: torch.Tensor, n_heads: int, head_dim: int
                 ) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, head_dim)


def attention(p, cfg, x: torch.Tensor, positions: torch.Tensor, *,
              causal: bool = True, kv_x: Optional[torch.Tensor] = None,
              use_rope: bool = True):
    """Full-sequence attention (prefill / encoder / cross).

    x: (B, S, D).  kv_x: the source of k/v (cross-attention), or None
    (self).  Returns (out (B, S, D), (k, v) heads (B, Sk, Hkv, hd) for the
    cache).
    """
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    src = x if kv_x is None else kv_x
    q = _split_heads(x @ p["wq"], hq, hd)
    k = _split_heads(src @ p["wk"], hkv, hd)
    v = _split_heads(src @ p["wv"], hkv, hd)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        kv_pos = positions if kv_x is None else torch.arange(
            src.shape[1], device=src.device)[None]
        k = rope(k, kv_pos, cfg.rope_theta)

    if cfg.attention_impl == "pallas" and x.shape[1] > 1:
        # (B, S, H, D) viewed as (B, H, S, D): the kernel reads the strides
        out = flash_ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal).transpose(1, 2)
    elif cfg.attention_impl == "blocked" and x.shape[1] > 1:
        out = blocked_attention(q, k, v, causal=causal)
    else:
        out = _reference_attention(q, k, v, causal=causal)
    b, s, _, _ = out.shape
    return out.reshape(b, s, hq * hd) @ p["wo"], (k, v)


def _reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, kv_valid: Optional[int] = None
                         ) -> torch.Tensor:
    """q: (B, Sq, Hq, hd), k/v: (B, Sk, Hkv, hd); kv_valid: length of the
    valid cache prefix, or None.  Scores and softmax in f32; the output
    is cast back to q's dtype."""
    b, sq, hq, hd = q.shape
    _, sk, hkv, _ = k.shape
    group = hq // hkv
    qg = q.reshape(b, sq, hkv, group, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * (
        hd ** -0.5)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        kpos = torch.arange(sk, device=q.device)[None, :]
        mask = mask & (qpos >= kpos)
    if kv_valid is not None:
        mask = mask & (torch.arange(sk, device=q.device)[None, :] < kv_valid)
    s = s.masked_fill(~mask, float("-inf"))  # broadcasts over (b, hkv, group)
    pr = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", pr, v.float())
    # (b, sq, hkv, group, hd) -> (b, sq, hq, hd): q-head index = h*group + g,
    # matching the reshape at entry
    return out.reshape(b, sq, hq, hd).to(q.dtype)


def init_layer_cache(cfg, batch: int, max_len: int, dtype,
                     device=None) -> dict:
    """Stacked KV cache: (L, B, max_len, Hkv, hd) x2 + position."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": 0,
    }


def decode_attention(p, cfg, x: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int, *,
                     use_rope: bool = True):
    """Single-step decode: x (B, 1, D); k/v_cache (B, Lmax, Hkv, hd);
    pos: number of tokens already in the cache.

    Writes the step's k/v into the caches in place (the reference returns
    updated copies) and returns (out (B, 1, D), k_cache, v_cache).
    """
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    b, s, _ = x.shape
    positions = torch.full((b, s), pos, dtype=torch.int32, device=x.device)
    q = _split_heads(x @ p["wq"], hq, hd)
    k = _split_heads(x @ p["wk"], hkv, hd)
    v = _split_heads(x @ p["wv"], hkv, hd)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    k_cache[:, pos:pos + s] = k
    v_cache[:, pos:pos + s] = v
    out = _reference_attention(q, k_cache, v_cache, causal=False,
                               kv_valid=pos + 1)
    out = out.reshape(b, s, hq * hd) @ p["wo"]
    return out, k_cache, v_cache
