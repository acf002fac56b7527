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

Decode follows the same field: under ``"pallas"`` a single-position
step attends over its cache with the hand-written decode-attention kernel
(:func:`repro_torch.kernels.decode_attention.ops.decode_attention`; its
plain version on CPU tensors), which reads the cache once in its own
dtype; otherwise it runs :func:`_reference_attention`, as the reference
does.  A cache split along its sequence, and a decode step's cross
attention, stay on their plain paths.

With ``tp`` (the mesh's ``model`` axis, :mod:`repro_torch.sharding.tp`)
and ``wo`` row-sharded there, attention (self, encoder and cross) is
head-parallel: each rank computes the query heads its rows of ``wo`` need
(:func:`~repro_torch.sharding.tp.head_plan`) and the key/value heads
they read, from its column blocks of ``wq``/``wk``/``wv``; a projection
sharded inside heads (GQA with fewer key/value heads than ranks) is
all-gathered over the axis and the rank takes its heads.  The partial
``wo`` product is all-reduced, or reduce-scattered along the sequence
under ``seq`` (sequence parallelism: ``x`` is then this rank's block of
the sequence, gathered at entry; so is a cross attention's source under
``kv_seq``).  Decode reads a cache block placed by
``rules.cache_pspec``: its heads (``cache_dim`` 2), its block of the
sequence (``cache_dim`` 1: each rank attends over its block and the
softmax's max and sums are all-reduced), or all of it (None); so does
the cross attention of a decode step (:func:`cross_decode_attention`),
on the cached encoder keys and values.
"""

from __future__ import annotations

from typing import Optional

import torch

import torch.distributed as dist

from ..core.obs import SPAN_ATTEND, SPAN_ROPE, program_span
from ..kernels.decode_attention import ops as decode_ops
from ..kernels.flash_attention import ops as flash_ops
from ..sharding import place, tp
from .blocked_attention import blocked_attention
from .layers import Params, dense_init, raw, rope

__all__ = ["attn_init", "attention", "cross_decode_attention",
           "decode_attention", "init_layer_cache"]


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
              use_rope: bool = True, t: Optional[tp.TP] = None,
              seq: bool = False, kv_seq: bool = False):
    """Full-sequence attention (prefill / encoder / cross).

    x: (B, S, D).  kv_x: the source of k/v (cross-attention), or None
    (self).  Returns (out (B, S, D), (k, v) heads (B, Sk, Hkv, hd) for the
    cache).  With ``t``, tensor-parallel (see the module's docstring):
    ``x`` and ``out`` are this rank's block of the sequence under
    ``seq``, ``kv_x`` its block of the source's under ``kv_seq``, and
    (k, v) hold the heads of this rank's cache block where its heads
    divide the axis, else every head.
    """
    if tp.sharded(t, raw(p, "wo"), 0):
        return _tp_attention(p, cfg, x, positions, t, seq, causal=causal,
                             use_rope=use_rope, kv_x=kv_x, kv_seq=kv_seq)
    # the weights whole on every rank: a sequence block is gathered first
    if seq:
        x = tp.gather(x, 1, t)
    if kv_seq:
        kv_x = tp.gather(kv_x, 1, t)
    out, kv = _whole_attention(p, cfg, x, positions, causal=causal,
                               kv_x=kv_x, use_rope=use_rope)
    return (tp.split(out, 1, t) if seq else out), kv


def _whole_attention(p, cfg, x, positions, *, causal, kv_x, use_rope):
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    src = x if kv_x is None else kv_x
    q = _split_heads(x @ p["wq"], hq, hd)
    k = _split_heads(src @ p["wk"], hkv, hd)
    v = _split_heads(src @ p["wv"], hkv, hd)
    if use_rope:
        with program_span(SPAN_ROPE):
            q = rope(q, positions, cfg.rope_theta)
            kv_pos = positions if kv_x is None else torch.arange(
                src.shape[1], device=src.device)[None]
            k = rope(k, kv_pos, cfg.rope_theta)
    with program_span(SPAN_ATTEND):
        out = _attend(cfg, q, k, v, causal=causal)
    b, s, _, _ = out.shape
    return out.reshape(b, s, hq * hd) @ p["wo"], (k, v)


def _attend(cfg, q, k, v, *, causal: bool) -> torch.Tensor:
    """The prefill attention of ``cfg.attention_impl`` on (B, S, H, D)
    heads."""
    if cfg.attention_impl == "pallas" and q.shape[1] > 1:
        # (B, S, H, D) viewed as (B, H, S, D): the kernel reads the strides
        return flash_ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal).transpose(1, 2)
    if cfg.attention_impl == "blocked" and q.shape[1] > 1:
        return blocked_attention(q, k, v, causal=causal)
    return _reference_attention(q, k, v, causal=causal)


def _decode_attend(cfg, q, k_cache, v_cache, valid: int) -> torch.Tensor:
    """A decode step's attention of ``cfg.attention_impl`` over the first
    ``valid`` positions of (B, Lmax, Hkv, D) caches."""
    if cfg.attention_impl == "pallas" and q.shape[1] == 1:
        return decode_ops.decode_attention(q, k_cache, v_cache, valid)
    return _reference_attention(q, k_cache, v_cache, causal=False,
                                kv_valid=valid)


def _heads(p, name: str, x: torch.Tensor, n_heads: int, hd: int,
           h0: int, h1: int, t: tp.TP, *, whole: bool = False):
    """Heads [h0, h1) of ``x @ p[name]`` (B, S, h1 - h0, hd), and all of
    them where ``whole`` or where they were needed to get these (else
    None).  A column-sharded weight gives this rank's block of columns,
    all-gathered over the axis unless it is exactly those heads; a
    replicated one gives every column."""
    b, s, _ = x.shape
    w = raw(p, name)
    if tp.sharded(t, w, 1):
        y = x @ place.local(w, keep_model=True)
        width = y.shape[-1]
        if (h0 * hd, h1 * hd) == (t.i * width, (t.i + 1) * width) \
                and not whole:
            return y.reshape(b, s, h1 - h0, hd), None
        y = tp.gather_sum(y, -1, t)
    else:
        # its gradient is partial: each rank reads other heads of it
        y = x @ place.local(w, place.current_batch_axes() + ("model",))
    y = y.reshape(b, s, n_heads, hd)
    return y[:, :, h0:h1], y


def _tp_attention(p, cfg, x, positions, t: tp.TP, seq: bool, *,
                  causal: bool, use_rope: bool, kv_x=None,
                  kv_seq: bool = False):
    """Head-parallel attention on this rank (module docstring); a cross
    attention's source ``kv_x`` enters as ``x`` does."""
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    plan = tp.head_plan(hq, hkv, hd, t.n, t.i)
    xin = tp.gather_sum(x, 1, t) if seq else tp.copy_to(x, t)
    src = xin if kv_x is None else (
        tp.gather_sum(kv_x, 1, t) if kv_seq else tp.copy_to(kv_x, t))
    b, s, _ = xin.shape
    q, _ = _heads(p, "wq", xin, hq, hd, plan.q0, plan.q1, t)
    k, k_all = _heads(p, "wk", src, hkv, hd, plan.kv0, plan.kv1, t)
    v, v_all = _heads(p, "wv", src, hkv, hd, plan.kv0, plan.kv1, t)
    if use_rope:
        with program_span(SPAN_ROPE):
            kv_pos = positions if kv_x is None else torch.arange(
                src.shape[1], device=src.device)[None]
            q = rope(q, positions, cfg.rope_theta)
            k_all = None if k_all is None else rope(k_all, kv_pos,
                                                    cfg.rope_theta)
            k = (rope(k, kv_pos, cfg.rope_theta) if k_all is None
                 else k_all[:, :, plan.kv0:plan.kv1])
    if plan.kv_index is not None:
        index = torch.as_tensor(plan.kv_index, device=x.device)
        k, v = k.index_select(2, index), v.index_select(2, index)
    with program_span(SPAN_ATTEND):
        out = _attend(cfg, q, k, v, causal=causal)
    out = out.reshape(b, s, -1)[..., plan.c0:plan.c1]
    out = out @ place.local(raw(p, "wo"), keep_model=True)
    out = tp.reduce_scatter(out, 1, t) if seq else tp.reduce_from(out, t)
    # the cache keeps this rank's heads where they divide the axis (its
    # query heads are then whole groups), else every head
    return out, ((k, v) if hkv % t.n == 0 else (k_all, v_all))


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
                     use_rope: bool = True, t: Optional[tp.TP] = None,
                     cache_dim: Optional[int] = None):
    """Single-step decode: x (B, 1, D); k/v_cache (B, Lmax, Hkv, hd);
    pos: number of tokens already in the cache.

    Writes the step's k/v into the caches in place (the reference returns
    updated copies) and returns (out (B, 1, D), k_cache, v_cache).  With
    ``t`` and ``wo`` row-sharded, the caches are this rank's block of a
    cache placed by ``rules.cache_pspec`` on the dim ``cache_dim``
    (module docstring).
    """
    if tp.sharded(t, raw(p, "wo"), 0):
        return _tp_decode_attention(p, cfg, x, k_cache, v_cache, pos, t,
                                    cache_dim, use_rope=use_rope)
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    b, s, _ = x.shape
    positions = torch.full((b, s), pos, dtype=torch.int32, device=x.device)
    q = _split_heads(x @ p["wq"], hq, hd)
    k = _split_heads(x @ p["wk"], hkv, hd)
    v = _split_heads(x @ p["wv"], hkv, hd)
    if use_rope:
        with program_span(SPAN_ROPE):
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
    k_cache[:, pos:pos + s] = k
    v_cache[:, pos:pos + s] = v
    with program_span(SPAN_ATTEND):
        out = _decode_attend(cfg, q, k_cache, v_cache, pos + 1)
    out = out.reshape(b, s, hq * hd) @ p["wo"]
    return out, k_cache, v_cache


def _tp_decode_attention(p, cfg, x, k_cache, v_cache, pos: int,
                         t: tp.TP, cache_dim: Optional[int], *,
                         use_rope: bool):
    """One decode step, head-parallel, on this rank's cache block."""
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    plan = tp.head_plan(hq, hkv, hd, t.n, t.i)
    b, s, _ = x.shape
    positions = torch.full((b, s), pos, dtype=torch.int32, device=x.device)
    if cache_dim == 2:
        # the cache holds this rank's heads, which divide the axis: so do
        # its query heads, in whole groups
        q, _ = _heads(p, "wq", x, hq, hd, plan.q0, plan.q1, t)
        k, _ = _heads(p, "wk", x, hkv, hd, plan.kv0, plan.kv1, t)
        v, _ = _heads(p, "wv", x, hkv, hd, plan.kv0, plan.kv1, t)
        lo = 0
    else:
        # every head over this rank's positions (cache_dim 1) or all
        _, q = _heads(p, "wq", x, hq, hd, 0, hq, t, whole=True)
        _, k = _heads(p, "wk", x, hkv, hd, 0, hkv, t, whole=True)
        _, v = _heads(p, "wv", x, hkv, hd, 0, hkv, t, whole=True)
        lo = t.i * k_cache.shape[1] if cache_dim == 1 else 0
    if use_rope:
        with program_span(SPAN_ROPE):
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
    if lo <= pos < lo + k_cache.shape[1]:
        k_cache[:, pos - lo:pos - lo + s] = k
        v_cache[:, pos - lo:pos - lo + s] = v
    with program_span(SPAN_ATTEND):
        if cache_dim == 1:
            out = _seq_block_attention(q, k_cache, v_cache, pos + 1 - lo, t)
        else:
            out = _decode_attend(cfg, q, k_cache, v_cache, pos + 1)
    out = out.reshape(b, s, -1)
    if cache_dim != 2:
        out = out[..., plan.q0 * hd:plan.q1 * hd]
    out = out[..., plan.c0:plan.c1] @ place.local(raw(p, "wo"),
                                                  keep_model=True)
    return tp.reduce_from(out, t), k_cache, v_cache


def cross_decode_attention(p, cfg, x: torch.Tensor, xk: torch.Tensor,
                           xv: torch.Tensor, *, t: Optional[tp.TP] = None,
                           cache_dim: Optional[int] = None) -> torch.Tensor:
    """One decode step's cross attention: x (B, 1, D) against the cached
    encoder keys and values xk/xv (B, Sk, Hkv, hd), which it does not
    update.  With ``t`` and ``wo`` row-sharded, xk/xv are this rank's
    block of a cache placed by ``rules.cache_pspec`` on ``cache_dim``, as
    :func:`decode_attention` reads its own."""
    hq, hd = cfg.n_heads, cfg.head_dim
    b, s, _ = x.shape
    if not tp.sharded(t, raw(p, "wo"), 0):
        q = _split_heads(x @ p["wq"], hq, hd)
        out = _reference_attention(q, xk, xv, causal=False)
        return out.reshape(b, s, hq * hd) @ p["wo"]
    plan = tp.head_plan(hq, cfg.n_kv_heads, hd, t.n, t.i)
    if cache_dim == 2:
        q, _ = _heads(p, "wq", x, hq, hd, plan.q0, plan.q1, t)
        out = _reference_attention(q, xk, xv, causal=False)
    else:
        _, q = _heads(p, "wq", x, hq, hd, 0, hq, t, whole=True)
        out = (_seq_block_attention(q, xk, xv, xk.shape[1], t)
               if cache_dim == 1 else
               _reference_attention(q, xk, xv, causal=False))
        out = out[:, :, plan.q0:plan.q1]
    out = out.reshape(b, s, -1)[..., plan.c0:plan.c1] @ place.local(
        raw(p, "wo"), keep_model=True)
    return tp.reduce_from(out, t)


def _seq_block_attention(q, k_cache, v_cache, valid: int, t: tp.TP
                         ) -> torch.Tensor:
    """Decode attention over a cache split along its sequence: this rank
    scores its block (the first ``valid`` positions of it count), and the
    softmax's max, its sum and the weighted values are reduced over the
    axis.  The result, (B, 1, Hq, hd) in q's dtype, is the same on every
    rank."""
    b, sq, hq, hd = q.shape
    _, sk, hkv, _ = k_cache.shape
    qg = q.reshape(b, sq, hkv, hq // hkv, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k_cache.float()) * (
        hd ** -0.5)
    mask = torch.arange(sk, device=q.device) < valid
    s = s.masked_fill(~mask, float("-inf"))
    top = s.amax(dim=-1, keepdim=True)
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=t.group)
    pr = torch.exp(s - top)
    denom = pr.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgqk,bkhd->bqhgd", pr, v_cache.float())
    dist.all_reduce(denom, group=t.group)
    dist.all_reduce(out, group=t.group)
    # (b, h, g, q, 1) -> (b, q, h, g, 1), beside out's (b, q, h, g, d)
    out = out / denom.permute(0, 3, 1, 2, 4)
    return out.reshape(b, sq, hq, hd).to(q.dtype)
