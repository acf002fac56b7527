"""GQA attention: init, prefill forward, cached decode.

The port of ``src/repro/models/attention.py``.  Activations are
(B, S, H, D), as in the reference.  ``cfg.attention_impl`` picks the
prefill path:

* ``"pallas"`` runs the hand-written Hopper flash-attention kernel
  (:func:`repro_torch.kernels.flash_attention.ops.flash_attention`; its
  plain version on CPU tensors);
* ``"reference"`` runs the plain einsum path, :func:`_reference_attention`;
* ``"blocked"`` (the reference's ``custom_vjp`` training attention) is
  not ported yet.

Decode stays on the plain path, as in the reference.  The reference's
cross-attention and no-RoPE options (``kv_x``, ``use_rope``, ``d_in``)
serve only the audio family and wait for its port.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels.flash_attention import ops as flash_ops
from .layers import Params, dense_init, rope

__all__ = ["attn_init", "attention", "decode_attention", "init_layer_cache"]


def attn_init(generator: torch.Generator, cfg, dtype) -> Params:
    d = cfg.d_model
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
              causal: bool = True):
    """Full-sequence self-attention (prefill).

    x: (B, S, D).  Returns (out (B, S, D), (k, v) heads (B, S, Hkv, hd)
    for the cache).
    """
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = rope(_split_heads(x @ p["wq"], hq, hd), positions, cfg.rope_theta)
    k = rope(_split_heads(x @ p["wk"], hkv, hd), positions, cfg.rope_theta)
    v = _split_heads(x @ p["wv"], hkv, hd)

    if cfg.attention_impl == "pallas" and x.shape[1] > 1:
        # (B, S, H, D) viewed as (B, H, S, D): the kernel reads the strides
        out = flash_ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal).transpose(1, 2)
    elif cfg.attention_impl == "blocked" and x.shape[1] > 1:
        raise NotImplementedError(
            "attention_impl='blocked' (models/blocked_attention.py, a "
            "custom_vjp for training) is not ported yet: ROADMAP Queue 1 "
            "item 8")
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
                     v_cache: torch.Tensor, pos: int):
    """Single-step decode: x (B, 1, D); k/v_cache (B, Lmax, Hkv, hd);
    pos: number of tokens already in the cache.

    Writes the step's k/v into the caches in place (the reference returns
    updated copies) and returns (out (B, 1, D), k_cache, v_cache).
    """
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    b, s, _ = x.shape
    positions = torch.full((b, s), pos, dtype=torch.int32, device=x.device)
    q = rope(_split_heads(x @ p["wq"], hq, hd), positions, cfg.rope_theta)
    k = rope(_split_heads(x @ p["wk"], hkv, hd), positions, cfg.rope_theta)
    v = _split_heads(x @ p["wv"], hkv, hd)
    k_cache[:, pos:pos + s] = k
    v_cache[:, pos:pos + s] = v
    out = _reference_attention(q, k_cache, v_cache, causal=False,
                               kv_valid=pos + 1)
    out = out.reshape(b, s, hq * hd) @ p["wo"]
    return out, k_cache, v_cache
