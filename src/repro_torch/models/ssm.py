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
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .layers import Params, dense_init, init_device, norm_apply, norm_init

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


def mlstm_apply(p, cfg, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D) (residual included)."""
    q, k, v, log_f, log_i, z = _mlstm_qkv(p, cfg, x)
    out, _ = chunked_gla(q, k, _with_ones(v), log_f, log_i, cfg.ssm_chunk)
    h_mix, den = out[..., :-1].float(), out[..., -1].float()
    return _mlstm_out(p, h_mix, den, z, x)


def mlstm_decode(p, cfg, x: torch.Tensor, state: torch.Tensor):
    """x: (B, 1, D); state: (B, H, dk, dv+1).  Returns (y, new_state)."""
    q, k, v, log_f, log_i, z = _mlstm_qkv(p, cfg, x)
    h, state = gla_decode_step(state, q[:, 0], k[:, 0], _with_ones(v)[:, 0],
                               log_f[:, 0], log_i[:, 0])
    h = h[:, None]                                 # (B, 1, H, dv+1)
    return _mlstm_out(p, h[..., :-1], h[..., -1], z, x), state


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


def slstm_apply(p, cfg, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D) (residual included).  Sequential over
    time: the sLSTM is not parallelizable over time (xLSTM paper §2)."""
    bsz, s, d = x.shape
    xn = norm_apply(p["ln"], x, cfg.norm)
    wx = xn @ p["w"]                                # (B, S, 4D)
    carry = tuple(torch.zeros(slstm_state_shape(cfg, bsz),
                              dtype=torch.float32, device=x.device)
                  for _ in range(3))
    r = p["r"].float()
    hs = []
    for t in range(s):
        carry, hout = _slstm_cell(p, cfg, r, wx[:, t], carry)
        hs.append(hout)
    hs = torch.stack(hs, dim=1).reshape(bsz, s, d).to(x.dtype)
    return x + hs @ p["wo"]


def slstm_decode(p, cfg, x: torch.Tensor, carry):
    """x: (B, 1, D); carry: (c, n, h) each (B, H, dh)."""
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


def mamba2_apply(p, cfg, x: torch.Tensor) -> torch.Tensor:
    q, k, v, log_f, log_i, z, _ = _mamba2_proj(p, cfg, x)
    out, _ = chunked_gla(q, k, v, log_f, log_i, cfg.ssm_chunk)
    return _mamba2_out(p, out, z, x)


def mamba2_decode(p, cfg, x: torch.Tensor, state: torch.Tensor,
                  conv_state: torch.Tensor):
    """x: (B, 1, D); state: (B, H, N, dh); conv_state: (B, 3, Di).
    Returns (y, new_state, new_conv_state)."""
    q, k, v, log_f, log_i, z, new_conv = _mamba2_proj(p, cfg, x, conv_state)
    h, state = gla_decode_step(
        state, q[:, 0], k[:, 0], v[:, 0], log_f[:, 0], log_i[:, 0])
    return _mamba2_out(p, h[:, None], z, x), state, new_conv


def mamba2_state_shapes(cfg, batch: int) -> tuple:
    di = 2 * cfg.d_model
    dh = di // cfg.n_heads
    return ((batch, cfg.n_heads, cfg.ssm_state, dh),
            (batch, _CONV_W - 1, di))
