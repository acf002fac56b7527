"""Sub-quadratic sequence mixers: the chunked gated-linear-attention
engine (which drives both xLSTM's mLSTM and Zamba2's Mamba2/SSD, both
gated linear recurrences) and the recurrent sLSTM cell.

The port of ``src/repro/models/ssm.py``: plain torch operations (the
reference is plain ``jnp`` with no Pallas kernel), the functions taking
the block's weights and ``cfg`` first, as there.  A Python loop over the
chunks (and, for the sLSTM, over the time steps) takes the place of
``jax.lax.scan``.

Recurrence (per head):  S_t = f_t · S_{t-1} + i_t · k_t v_tᵀ,   h_t = q_t S_t

Within a chunk the contribution is a (c × c) masked product; across
chunks a (dk × dv) f32 state is carried.  Gates live in log space and
``log_i`` is clipped at ±8.  The casts stay where the reference has
them: the chunk products run in f32 and :func:`chunked_gla` returns
``v``'s dtype, so a bf16 model rounds the mixer's output to bf16 where
the reference does.

Tensor parallelism.  With ``t`` (the mesh's ``model`` axis,
:mod:`repro_torch.sharding.tp`) and the block's projections placed
column- and row-parallel there by the reference's specs, each mixer
computes what XLA makes of those specs: the normalised input enters by
``copy_to`` (under ``seq``, this rank's block of the sequence, by
``gather_sum``: the recurrence needs the whole sequence), the rank
computes its block of the inner width and the heads it covers, and the
row-parallel down-projection leaves by ``reduce_from``
(``reduce_scatter``).

* mLSTM: ``wu``, ``wz``, ``wq``, ``wk``, ``wv`` column-parallel, ``wo``
  row-parallel.  u is gathered (``wq``/``wk``/``wv`` read all of it),
  q, k and v are the rank's heads, the replicated gates ``wi``/``wf``
  are computed whole and sliced to them; z's block is h's.
* sLSTM: ``w`` column-parallel, ``wo`` row-parallel.  The recurrent
  ``r`` is replicated and the carry a small replicated state
  (``rules.cache_pspec``), so the time loop runs alike on every rank on
  ``w``'s product gathered whole, and the rank takes its columns of the
  loop's output into ``wo``.  That is what the reference's specs imply;
  the loop is no faster for it.
* Mamba2: ``w_in`` column-parallel ([u | z] by contiguous blocks, moved
  to the rank's block of each by ``tp.part_blocks``), ``conv`` sharded
  on its channels (and its state with it), ``w_out`` row-parallel; the
  replicated ``wb``/``wc``/``wdt`` computed whole (k and q are shared
  across heads); the gated norm ``gn`` over all of Di sums its squares
  locally and all-reduces them (``tp.mean_squares``).

Where the heads do not divide the axis (xlstm's 4 heads at |model| 16,
or 2 at 4) a rank's columns cut a head: it computes the heads its
columns need (``tp.head_plan``) on q, k and v gathered over the axis,
and takes its columns of the output, so no reshape to (B, S, H, dh)
ever cuts a head.  A decode step on a state held whole (its heads do not
divide the axis) computes every head, so the state stays whole and
alike.  A replicated weight that each rank uses on its own heads takes
a gradient summed over the axis; one used alike (``r``, the sLSTM's
bias) does not.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..sharding import place, tp
from .layers import (Params, dense_init, init_device, norm_apply, norm_init,
                     raw)

__all__ = [
    "MLSTMBlock", "SLSTMBlock", "Mamba2Block",
    "chunked_gla", "gla_decode_step",
    "mlstm_init", "mlstm_apply", "mlstm_decode", "mlstm_state_shape",
    "slstm_init", "slstm_apply", "slstm_decode", "slstm_state_shape",
    "mamba2_init", "mamba2_apply", "mamba2_decode", "mamba2_state_shapes",
]

_LOG_I_CLIP = 8.0
_CONV_W = 4


class MLSTMBlock(Params):
    """mLSTM block weights: ``ln``; up-projections ``wu``, ``wz``;
    ``wq``, ``wk``, ``wv``; f32 gates ``wi``, ``wf``, ``bi``, ``bf``;
    down-projection ``wo``."""


class SLSTMBlock(Params):
    """sLSTM block weights: ``ln``; input projection ``w`` (z, i, f, o);
    block-diagonal recurrence ``r`` (H, dh, 4 dh); f32 bias ``b``;
    ``wo``."""


class Mamba2Block(Params):
    """Mamba2 block weights: ``ln``; ``w_in`` (u, z); depthwise ``conv``
    (4, Di); ``wb`` (B -> k), ``wc`` (C -> q); f32 ``wdt``, ``bdt``,
    ``a_log``; the gated norm ``gn``; ``w_out``."""


# ---------------------------------------------------------------------------
# Chunked gated linear attention
# ---------------------------------------------------------------------------


def chunked_gla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_f: torch.Tensor, log_i: torch.Tensor, chunk: int,
                state0: Optional[torch.Tensor] = None):
    """q/k: (B, S, H, dk); v: (B, S, H, dv); log_f/log_i: (B, S, H).

    Returns (out (B, S, H, dv) in ``v``'s dtype, final_state (B, H, dk,
    dv) f32).  A length that is not a multiple of ``chunk`` is padded
    with zeros: zero k/v leave the state untouched and ``log_f = 0``
    means no decay."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    s_real = s
    pad = (-s) % chunk
    if pad:
        def zpad(x):
            return F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))
        q, k, v, log_f, log_i = map(zpad, (q, k, v, log_f, log_i))
        s = s + pad
    nc = s // chunk
    f32 = torch.float32

    def chunks(x):
        # (B, S, ...) -> (B, nc, c, ...)
        return x.to(f32).reshape(b, nc, chunk, *x.shape[2:])

    qc, kc, vc, lf, li = map(chunks, (q, k, v, log_f, log_i))
    li = li.clamp(-_LOG_I_CLIP, _LOG_I_CLIP)
    state = (torch.zeros((b, h, dk, dv), dtype=f32, device=q.device)
             if state0 is None else state0.to(f32))
    tril = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=q.device).tril()

    outs = []
    for c in range(nc):
        qx, kx, vx, lfx, lix = qc[:, c], kc[:, c], vc[:, c], lf[:, c], li[:, c]
        a = torch.cumsum(lfx, dim=1)                 # inclusive decay prefix
        ah = a.transpose(1, 2)                       # (B, H, c)
        lih = lix.transpose(1, 2)
        # intra-chunk: gamma_ij = A_i - A_j + log_i_j (j <= i); the upper
        # triangle is masked before exp, where it can be large and positive
        gamma = ah[:, :, :, None] - ah[:, :, None, :] + lih[:, :, None, :]
        scores = torch.einsum("bihd,bjhd->bhij", qx, kx)
        scores = torch.where(
            tril, scores * torch.exp(torch.where(tril, gamma, 0.0)), 0.0)
        intra = torch.einsum("bhij,bjhd->bihd", scores, vx)
        # inter-chunk: decayed query against the carried state
        qdec = qx * torch.exp(a)[..., None]
        inter = torch.einsum("bihd,bhde->bihe", qdec, state)
        # state update
        a_last = a[:, -1:, :]                        # (B, 1, H)
        kdec = kx * torch.exp(a_last - a + lix)[..., None]
        state = (torch.exp(a_last[:, 0])[..., None, None] * state
                 + torch.einsum("bjhd,bjhe->bhde", kdec, vx))
        outs.append(intra + inter)
    out = torch.cat(outs, dim=1)[:, :s_real]
    return out.to(v.dtype), state


def gla_decode_step(state: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, log_f: torch.Tensor,
                    log_i: torch.Tensor):
    """Single-token recurrent step.  q/k: (B, H, dk); v: (B, H, dv);
    log_f/log_i: (B, H).  Returns (h (B, H, dv) f32, new_state)."""
    f32 = torch.float32
    q, k, v = q.to(f32), k.to(f32), v.to(f32)
    li = log_i.to(f32).clamp(-_LOG_I_CLIP, _LOG_I_CLIP)
    f = torch.exp(log_f.to(f32))[..., None, None]
    i = torch.exp(li)[..., None, None]
    state = f * state + i * (k[..., :, None] * v[..., None, :])
    h = torch.einsum("bhd,bhde->bhe", q, state)
    return h, state


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM): up-proj -> matrix-memory mixer -> gated down-proj
# ---------------------------------------------------------------------------


def mlstm_init(generator: torch.Generator, cfg, dtype) -> MLSTMBlock:
    d = cfg.d_model
    di = 2 * d
    h = cfg.n_heads
    dev = init_device(generator)
    f32 = torch.float32
    return MLSTMBlock(
        ln=norm_init(d, cfg.norm, f32, device=dev),
        wu=dense_init(generator, (d, di), dtype),
        wz=dense_init(generator, (d, di), dtype),
        wq=dense_init(generator, (di, di), dtype),
        wk=dense_init(generator, (di, di), dtype),
        wv=dense_init(generator, (di, di), dtype),
        wi=dense_init(generator, (d, h), f32),
        wf=dense_init(generator, (d, h), f32),
        bi=torch.zeros(h, dtype=f32, device=dev),
        bf=torch.full((h,), 3.0, dtype=f32, device=dev),  # open forget gates
        wo=dense_init(generator, (di, d), dtype),
    )


def _mlstm_qkv(p, cfg, x: torch.Tensor):
    b, s, _ = x.shape
    h = cfg.n_heads
    di = p["wu"].shape[1]
    dh = di // h
    xn = norm_apply(p["ln"], x, cfg.norm)
    u = xn @ p["wu"]
    z = xn @ p["wz"]
    q = (u @ p["wq"]).reshape(b, s, h, dh)
    k = (u @ p["wk"]).reshape(b, s, h, dh) * (dh ** -0.5)
    v = (u @ p["wv"]).reshape(b, s, h, dh)
    xf = xn.float()
    log_f = F.logsigmoid(xf @ p["wf"] + p["bf"])          # (B, S, H)
    log_i = xf @ p["wi"] + p["bi"]                        # exp input gate
    return q, k, v, log_f, log_i, z


def _mlstm_out(p, h_mix: torch.Tensor, den: torch.Tensor, z: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    # normalize by |denominator| (the xLSTM max(|n q|, 1) stabilizer)
    h = h_mix / den.abs().clamp(min=1.0)[..., None]
    b, s = h.shape[:2]
    h = h.reshape(b, s, -1).to(x.dtype)
    return x + (h * F.silu(z)) @ p["wo"]


def _with_ones(v: torch.Tensor) -> torch.Tensor:
    """v with a ones column: the state's last column sums the normalizer
    (the denominator trick)."""
    ones = torch.ones((*v.shape[:-1], 1), dtype=v.dtype, device=v.device)
    return torch.cat([v, ones], dim=-1)


def mlstm_apply(p, cfg, x: torch.Tensor, t: Optional[tp.TP] = None,
                seq: bool = False) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D) (residual included); with ``t``,
    tensor-parallel (module docstring), ``x`` this rank's block of the
    sequence under ``seq``."""
    if _computes_tp(p, t, _MLSTM_TP):
        return _mlstm_tp(_tp_weights(p, t, seq), cfg, x, t, seq)[0]
    return tp.whole(lambda x: _mlstm_whole(p, cfg, x), x, t, seq)


def _mlstm_whole(p, cfg, x: torch.Tensor) -> torch.Tensor:
    q, k, v, log_f, log_i, z = _mlstm_qkv(p, cfg, x)
    out, _ = chunked_gla(q, k, _with_ones(v), log_f, log_i, cfg.ssm_chunk)
    h_mix, den = out[..., :-1].float(), out[..., -1].float()
    return _mlstm_out(p, h_mix, den, z, x)


def mlstm_decode(p, cfg, x: torch.Tensor, state: torch.Tensor,
                 t: Optional[tp.TP] = None):
    """x: (B, 1, D); state: (B, H, dk, dv+1), this rank's heads of a
    state placed by ``rules.cache_pspec`` with ``t``.  Returns (y,
    new_state)."""
    if _computes_tp(p, t, _MLSTM_TP):
        return _mlstm_tp(_tp_weights(p, t, False), cfg, x, t, False,
                         state=state)
    q, k, v, log_f, log_i, z = _mlstm_qkv(p, cfg, x)
    h, state = gla_decode_step(state, q[:, 0], k[:, 0], _with_ones(v)[:, 0],
                               log_f[:, 0], log_i[:, 0])
    h = h[:, None]                                 # (B, 1, H, dv+1)
    return _mlstm_out(p, h[..., :-1], h[..., -1], z, x), state


def _mlstm_tp(w: dict, cfg, x: torch.Tensor, t: tp.TP, seq: bool,
              state: Optional[torch.Tensor] = None):
    """The mLSTM on this rank (module docstring), its weights ``w`` as
    :func:`_tp_weights` reads them: the full sequence (``state`` None) or
    one decode step from ``state``.  Returns (y, new_state or None)."""
    h = cfg.n_heads
    xin = _tp_enter(norm_apply(w["ln"], x, cfg.norm), t, seq)
    b, s, _ = xin.shape
    z = xin @ w["wz"]                              # this rank's columns
    dh = z.shape[-1] * t.n // h
    plan = _mixer_plan(h, dh, t, state)
    u = tp.gather_sum(xin @ w["wu"], -1, t)
    q = _head_block(u @ w["wq"], plan, dh, t)
    k = _head_block(u @ w["wk"], plan, dh, t) * (dh ** -0.5)
    v = _with_ones(_head_block(u @ w["wv"], plan, dh, t))
    xf = xin.float()
    heads = slice(plan.q0, plan.q1)
    log_f = F.logsigmoid(xf @ w["wf"] + w["bf"])[..., heads]
    log_i = (xf @ w["wi"] + w["bi"])[..., heads]
    if state is None:
        out, _ = chunked_gla(q, k, v, log_f, log_i, cfg.ssm_chunk)
    else:
        out, state = gla_decode_step(state, q[:, 0], k[:, 0], v[:, 0],
                                     log_f[:, 0], log_i[:, 0])
        out = out[:, None]
    h_mix, den = out[..., :-1].float(), out[..., -1].float()
    hm = (h_mix / den.abs().clamp(min=1.0)[..., None]).reshape(b, s, -1)
    hm = hm[..., plan.c0:plan.c1].to(x.dtype)
    return x + _tp_leave((hm * F.silu(z)) @ w["wo"], t, seq), state


def mlstm_state_shape(cfg, batch: int) -> tuple:
    di = 2 * cfg.d_model
    dh = di // cfg.n_heads
    return (batch, cfg.n_heads, dh, dh + 1)


# ---------------------------------------------------------------------------
# sLSTM block (xLSTM): recurrent scalar-memory cell with head-block mixing
# ---------------------------------------------------------------------------


def slstm_init(generator: torch.Generator, cfg, dtype) -> SLSTMBlock:
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    dev = init_device(generator)
    f32 = torch.float32
    return SLSTMBlock(
        ln=norm_init(d, cfg.norm, f32, device=dev),
        w=dense_init(generator, (d, 4 * d), dtype),          # z, i, f, o
        r=dense_init(generator, (h, dh, 4 * dh), dtype),     # block recurrent
        b=torch.cat([torch.zeros(2 * d, dtype=f32, device=dev),
                     torch.full((d,), 2.0, dtype=f32, device=dev),  # forget
                     torch.zeros(d, dtype=f32, device=dev)]),
        wo=dense_init(generator, (d, d), dtype),
    )


def _slstm_cell(p, cfg, r: torch.Tensor, wx_t: torch.Tensor, carry):
    """wx_t: (B, 4D) input projection of one step; ``r``: ``p["r"]`` in
    f32 (the reference's einsum promotes it so)."""
    c, n, hprev = carry                            # each (B, H, dh) f32
    b = wx_t.shape[0]
    heads, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    rec = torch.einsum("bhd,hde->bhe", hprev, r).reshape(b, 4 * cfg.d_model)
    pre = wx_t.float() + rec + p["b"]
    z, i, f, o = torch.split(pre, cfg.d_model, dim=-1)
    z = torch.tanh(z).reshape(b, heads, dh)
    i = torch.exp(i.clamp(-_LOG_I_CLIP, _LOG_I_CLIP)).reshape(b, heads, dh)
    f = torch.sigmoid(f).reshape(b, heads, dh)
    o = torch.sigmoid(o).reshape(b, heads, dh)
    c = f * c + i * z
    n = f * n + i
    hout = o * c / n.abs().clamp(min=1.0)
    return (c, n, hout), hout


def slstm_apply(p, cfg, x: torch.Tensor, t: Optional[tp.TP] = None,
                seq: bool = False) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D) (residual included).  Sequential over
    time: the sLSTM is not parallelizable over time (xLSTM paper §2).
    With ``t``, tensor-parallel (module docstring): the loop runs alike
    on every rank."""
    if _computes_tp(p, t, _SLSTM_TP):
        return _slstm_tp(_tp_weights(p, t, seq, alike=("r", "b")), cfg, x,
                         t, seq)[0]
    return tp.whole(lambda x: _slstm_whole(p, cfg, x), x, t, seq)


def _slstm_scan(p, cfg, wx: torch.Tensor, dtype) -> torch.Tensor:
    """The time loop from zero states over ``wx`` (B, S, 4D): the cells'
    outputs (B, S, D) in ``dtype``."""
    bsz, s, _ = wx.shape
    carry = tuple(torch.zeros(slstm_state_shape(cfg, bsz),
                              dtype=torch.float32, device=wx.device)
                  for _ in range(3))
    r = p["r"].float()
    hs = []
    for i in range(s):
        carry, hout = _slstm_cell(p, cfg, r, wx[:, i], carry)
        hs.append(hout)
    return torch.stack(hs, dim=1).reshape(bsz, s, cfg.d_model).to(dtype)


def _slstm_whole(p, cfg, x: torch.Tensor) -> torch.Tensor:
    xn = norm_apply(p["ln"], x, cfg.norm)
    wx = xn @ p["w"]                                # (B, S, 4D)
    return x + _slstm_scan(p, cfg, wx, x.dtype) @ p["wo"]


def _slstm_tp(w: dict, cfg, x: torch.Tensor, t: tp.TP, seq: bool,
              carry=None):
    """The sLSTM on this rank (module docstring): the full sequence
    (``carry`` None) or one decode step.  Returns (y, new carry or
    None)."""
    xin = _tp_enter(norm_apply(w["ln"], x, cfg.norm), t, seq)
    # [z | i | f | o] gathered whole: each rank runs the loop on all of it
    wx = tp.gather(xin @ w["w"], -1, t)
    if carry is None:
        hs = _slstm_scan(w, cfg, wx, x.dtype)
    else:
        carry, hout = _slstm_cell(w, cfg, w["r"].float(), wx[:, 0], carry)
        hs = hout.reshape(x.shape[0], 1, cfg.d_model).to(x.dtype)
    return x + _tp_leave(tp.split(hs, -1, t) @ w["wo"], t, seq), carry


def slstm_decode(p, cfg, x: torch.Tensor, carry, t: Optional[tp.TP] = None):
    """x: (B, 1, D); carry: (c, n, h) each (B, H, dh), replicated."""
    if _computes_tp(p, t, _SLSTM_TP):
        return _slstm_tp(_tp_weights(p, t, False, alike=("r", "b")), cfg,
                         x, t, False, carry=carry)
    xn = norm_apply(p["ln"], x, cfg.norm)
    wx = (xn @ p["w"])[:, 0]
    carry, hout = _slstm_cell(p, cfg, p["r"].float(), wx, carry)
    hs = hout.reshape(x.shape[0], 1, cfg.d_model).to(x.dtype)
    return x + hs @ p["wo"], carry


def slstm_state_shape(cfg, batch: int) -> tuple:
    return (batch, cfg.n_heads, cfg.d_model // cfg.n_heads)


# ---------------------------------------------------------------------------
# Mamba2 block (Zamba2): SSD as gated linear attention with shared B/C
# ---------------------------------------------------------------------------


def mamba2_init(generator: torch.Generator, cfg, dtype) -> Mamba2Block:
    d = cfg.d_model
    di = 2 * d
    n = cfg.ssm_state
    h = cfg.n_heads
    dev = init_device(generator)
    f32 = torch.float32
    return Mamba2Block(
        ln=norm_init(d, cfg.norm, f32, device=dev),
        w_in=dense_init(generator, (d, 2 * di), dtype),          # u, z
        conv=dense_init(generator, (_CONV_W, di), dtype, scale=0.5),
        wb=dense_init(generator, (d, n), dtype),                 # B (-> k)
        wc=dense_init(generator, (d, n), dtype),                 # C (-> q)
        wdt=dense_init(generator, (d, h), f32),                  # Δ per head
        bdt=torch.full((h,), -2.0, dtype=f32, device=dev),
        a_log=torch.zeros(h, dtype=f32, device=dev),             # decay
        gn=norm_init(di, "rmsnorm", f32, device=dev),
        w_out=dense_init(generator, (di, d), dtype),
    )


def _mamba2_proj(p, cfg, x: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None):
    """Returns q, k, v, log_f, log_i, z, new_conv_state."""
    b, s, d = x.shape
    di = 2 * d
    h = cfg.n_heads
    dh = di // h
    n = cfg.ssm_state
    xn = norm_apply(p["ln"], x, cfg.norm)
    uz = xn @ p["w_in"]
    u, z = uz[..., :di], uz[..., di:]
    # depthwise causal conv (width 4) on the u path
    if conv_state is None:
        upad = F.pad(u, (0, 0, _CONV_W - 1, 0))
    else:
        upad = torch.cat([conv_state.to(u.dtype), u], dim=1)
    new_conv = upad[:, -(_CONV_W - 1):, :]
    # four products summed in the reference's order, each rounded in u's
    # dtype
    u = sum(upad[:, i:i + s, :] * p["conv"][i] for i in range(_CONV_W))
    u = F.silu(u)
    xf = xn.float()
    dt = F.softplus(xf @ p["wdt"] + p["bdt"])                 # (B, S, H)
    log_f = -dt * torch.exp(p["a_log"])                       # a_t = exp(-Δ·A)
    log_i = torch.log(dt + 1e-6)                              # Δ scales input
    k = (xn @ p["wb"])[:, :, None, :].expand(b, s, h, n)
    q = (xn @ p["wc"])[:, :, None, :].expand(b, s, h, n)
    v = u.reshape(b, s, h, dh)
    return q, k, v, log_f, log_i, z, new_conv


def _mamba2_out(p, h_mix: torch.Tensor, z: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    b, s = h_mix.shape[:2]
    hflat = h_mix.reshape(b, s, -1)
    hflat = norm_apply(p["gn"], hflat.to(x.dtype), "rmsnorm")
    return x + (hflat * F.silu(z)) @ p["w_out"]


def mamba2_apply(p, cfg, x: torch.Tensor, t: Optional[tp.TP] = None,
                 seq: bool = False) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D) (residual included); with ``t``,
    tensor-parallel (module docstring)."""
    if _computes_tp(p, t, _MAMBA2_TP):
        return _mamba2_tp(_tp_weights(p, t, seq), cfg, x, t, seq)[0]
    return tp.whole(lambda x: _mamba2_whole(p, cfg, x), x, t, seq)


def _mamba2_whole(p, cfg, x: torch.Tensor) -> torch.Tensor:
    q, k, v, log_f, log_i, z, _ = _mamba2_proj(p, cfg, x)
    out, _ = chunked_gla(q, k, v, log_f, log_i, cfg.ssm_chunk)
    return _mamba2_out(p, out, z, x)


def _mamba2_tp(w: dict, cfg, x: torch.Tensor, t: tp.TP, seq: bool,
               state: Optional[torch.Tensor] = None,
               conv_state: Optional[torch.Tensor] = None):
    """Mamba2 on this rank (module docstring): the full sequence
    (``state`` None) or one decode step from ``state`` and this rank's
    channels of ``conv_state``.  Returns (y, new_state or None,
    new_conv_state)."""
    h, n = cfg.n_heads, cfg.ssm_state
    xin = _tp_enter(norm_apply(w["ln"], x, cfg.norm), t, seq)
    b, s, _ = xin.shape
    u, z = tp.part_blocks(xin @ w["w_in"], 2, -1, t).chunk(2, dim=-1)
    width = u.shape[-1]                            # this rank's channels
    di = width * t.n
    # the causal conv on this rank's channels, as _mamba2_proj runs it
    if conv_state is None:
        upad = F.pad(u, (0, 0, _CONV_W - 1, 0))
    else:
        upad = torch.cat([conv_state.to(u.dtype), u], dim=1)
    new_conv = upad[:, -(_CONV_W - 1):, :]
    u = F.silu(sum(upad[:, i:i + s, :] * w["conv"][i]
                   for i in range(_CONV_W)))
    plan = _mixer_plan(h, di // h, t, state)
    heads = slice(plan.q0, plan.q1)
    xf = xin.float()
    dt = F.softplus(xf @ w["wdt"] + w["bdt"])[..., heads]
    log_f = -dt * torch.exp(w["a_log"][heads])
    log_i = torch.log(dt + 1e-6)
    nh = plan.q1 - plan.q0
    k = (xin @ w["wb"])[:, :, None, :].expand(b, s, nh, n)
    q = (xin @ w["wc"])[:, :, None, :].expand(b, s, nh, n)
    v = _head_block(u, plan, di // h, t)
    if state is None:
        out, _ = chunked_gla(q, k, v, log_f, log_i, cfg.ssm_chunk)
    else:
        out, state = gla_decode_step(state, q[:, 0], k[:, 0], v[:, 0],
                                     log_f[:, 0], log_i[:, 0])
        out = out[:, None]
    hb = out.reshape(b, s, -1)[..., plan.c0:plan.c1].to(x.dtype)
    # the gated RMSNorm over all of Di, on this rank's block of it
    scale = w["gn"]["scale"][t.i * width:(t.i + 1) * width]
    hb = (hb.float() * torch.rsqrt(tp.mean_squares(hb, t) + 1e-6)
          * scale.float()).to(x.dtype)
    return (x + _tp_leave((hb * F.silu(z)) @ w["w_out"], t, seq), state,
            new_conv)


def mamba2_decode(p, cfg, x: torch.Tensor, state: torch.Tensor,
                  conv_state: torch.Tensor, t: Optional[tp.TP] = None):
    """x: (B, 1, D); state: (B, H, N, dh); conv_state: (B, 3, Di); with
    ``t``, this rank's blocks of states placed by ``rules.cache_pspec``.
    Returns (y, new_state, new_conv_state)."""
    if _computes_tp(p, t, _MAMBA2_TP):
        return _mamba2_tp(_tp_weights(p, t, False), cfg, x, t, False,
                          state=state, conv_state=conv_state)
    q, k, v, log_f, log_i, z, new_conv = _mamba2_proj(p, cfg, x, conv_state)
    h, state = gla_decode_step(
        state, q[:, 0], k[:, 0], v[:, 0], log_f[:, 0], log_i[:, 0])
    return _mamba2_out(p, h[:, None], z, x), state, new_conv


def mamba2_state_shapes(cfg, batch: int) -> tuple:
    di = 2 * cfg.d_model
    dh = di // cfg.n_heads
    return ((batch, cfg.n_heads, cfg.ssm_state, dh),
            (batch, _CONV_W - 1, di))


# ---------------------------------------------------------------------------
# tensor parallelism (module docstring)
# ---------------------------------------------------------------------------

#: (weights sharded on their last dim: the column-parallel projections
#: and Mamba2's conv channels; the row-parallel ones, on their first) of
#: each mixer's tensor-parallel path
_MLSTM_TP = (("wu", "wz", "wq", "wk", "wv"), ("wo",))
_SLSTM_TP = (("w",), ("wo",))
_MAMBA2_TP = (("w_in", "conv"), ("w_out",))


def _computes_tp(p, t: Optional[tp.TP], roles: tuple) -> bool:
    """The block computes tensor-parallel: its ``roles`` weights are all
    sharded on the ``model`` axis, the columns on their last dim and the
    rows on their first."""
    columns, rows = roles
    return t is not None and all(
        tp.sharded(t, raw(p, n), -1) for n in columns) and all(
        tp.sharded(t, raw(p, n), 0) for n in rows)


def _tp_weights(p, t: tp.TP, seq: bool, alike: tuple = ()) -> dict:
    """The block's weights as this rank computes with them: a weight the
    ``model`` axis shards is its block; a replicated one takes a gradient
    summed over the axis (each rank uses it on its own heads), but those
    in ``alike`` (used alike on every rank) and the input norm ``ln``
    (unless ``seq``: each rank normalises other positions); the gated
    norm ``gn`` whole, its gradient summed too."""
    axes = place.current_batch_axes()
    summed = axes + ("model",)
    out = {}
    for name, w in p._parameters.items():
        out[name] = (place.local(w, keep_model=True)
                     if tp.model_dim(w) is not None else
                     place.local(w, axes if name in alike else summed))
    for name, sub in p.named_children():
        over = summed if name == "gn" or seq else axes
        out[name] = {k: place.local(w, over)
                     for k, w in sub._parameters.items()}
    return out


def _tp_enter(xn: torch.Tensor, t: tp.TP, seq: bool) -> torch.Tensor:
    """The normalised input entering rank-distinct work: the whole
    sequence, gathered from this rank's block under ``seq``."""
    return tp.gather_sum(xn, 1, t) if seq else tp.copy_to(xn, t)


def _tp_leave(y: torch.Tensor, t: tp.TP, seq: bool) -> torch.Tensor:
    """A row-parallel product summed over the axis (this rank's block of
    the sequence under ``seq``)."""
    return tp.reduce_scatter(y, 1, t) if seq else tp.reduce_from(y, t)


def _mixer_plan(h: int, dh: int, t: tp.TP,
                state: Optional[torch.Tensor] = None) -> tp.HeadPlan:
    """The heads this rank computes and its output columns among them:
    ``tp.head_plan``'s, or every head where a decode ``state`` holds them
    all (it stays whole, and alike on every rank)."""
    if state is not None and state.shape[1] == h:
        width = h * dh // t.n
        return tp.HeadPlan(0, h, 0, h, None, t.i * width, (t.i + 1) * width)
    return tp.head_plan(h, h, dh, t.n, t.i)


def _head_block(y: torch.Tensor, plan: tp.HeadPlan, dh: int, t: tp.TP
                ) -> torch.Tensor:
    """Heads ``[plan.q0, plan.q1)`` (B, S, nh, dh) of a head-major
    product whose column block ``y`` (B, S, W / n) this rank holds:
    ``y`` itself where it is those heads, else gathered over the axis."""
    b, s, width = y.shape
    if (plan.c0, plan.c1) != (0, width) or (plan.q1 - plan.q0) * dh != width:
        y = tp.gather_sum(y, -1, t)[..., plan.q0 * dh:plan.q1 * dh]
    return y.reshape(b, s, plan.q1 - plan.q0, dh)
