"""Analytic FLOP/byte estimates per (arch × shape) cell.

Copied from ``src/repro/launch/estimate.py``; the parameter bytes come
from the port's meta-device ``param_shapes``.  The roofline uses these
analytic counts derived from the model structure — the same arithmetic
MFU calculators use.

Conventions:
  * a dot of (M,K)x(K,N) counts 2·M·K·N flops;
  * causal attention halves the S² term;
  * train = 3x forward (fwd + 2x bwd) on matmul flops, +1 forward when
    full remat is on;
  * MoE expert flops are counted at *dispatched capacity* (top-k ×
    capacity_factor) — padding slots burn real tensor-core cycles;
  * HBM bytes: parameter traffic (once fwd, once bwd, remat re-read,
    optimizer moment read/write in f32), activation traffic per block
    (~12 residual-width r/w), attention score traffic only for the
    reference (non-blocked) impl, logits, KV-cache traffic for decode.
"""

from __future__ import annotations

__all__ = ["cell_estimate"]


def _dense_layer_flops(cfg, s_ctx):
    """Per-token forward flops for one dense/moe attention block."""
    d, f = cfg.d_model, cfg.d_ff
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    proj = 2 * d * (hq + 2 * hkv) * hd + 2 * hq * hd * d
    scores = 2 * 2 * s_ctx * hq * hd          # QK^T + PV over context
    if cfg.is_moe:
        mlp = (2 * d * cfg.n_experts                       # router
               + 2 * 3 * d * f * cfg.experts_per_token * cfg.capacity_factor)
    else:
        mlp = 2 * 3 * d * f
    return proj + scores + mlp


def _mlstm_layer_flops(cfg):
    d = cfg.d_model
    di = 2 * d
    dh = di // cfg.n_heads
    c = cfg.ssm_chunk
    proj = 2 * d * di * 2 + 2 * di * di * 3 + 2 * di * d
    # intra-chunk (causal half) + inter-chunk state read/update
    mixer = 2 * c * di * 0.5 * 2 + 2 * 2 * cfg.n_heads * dh * dh
    return proj + mixer


def _mamba_layer_flops(cfg):
    d = cfg.d_model
    di = 2 * d
    n = cfg.ssm_state
    c = cfg.ssm_chunk
    proj = 2 * d * 2 * di + 2 * d * 2 * n + 2 * d * cfg.n_heads + 2 * di * d
    mixer = 2 * c * (n + di) * 0.5 + 2 * 2 * n * di
    return proj + mixer


def _fwd_flops(cfg, s, batch, kind):
    """Global forward flops for one step."""
    tokens = batch * (1 if kind == "decode" else s)
    s_ctx = s / 2 if kind != "decode" else s   # decode attends full cache
    head = 2 * cfg.d_model * cfg.vocab_size
    if kind == "prefill":
        head_tokens = batch                    # last_only unembed
    else:
        head_tokens = tokens
    total = head * head_tokens

    if cfg.family in ("dense", "moe", "vlm"):
        total += tokens * cfg.n_layers * _dense_layer_flops(cfg, s_ctx)
    elif cfg.family == "audio":
        enc_tokens = batch * cfg.encoder_seq
        enc_layer = _dense_layer_flops(cfg, cfg.encoder_seq)  # bidirectional
        if kind != "decode":
            total += enc_tokens * cfg.encoder_layers * enc_layer
        dec_self = _dense_layer_flops(cfg, s_ctx)
        cross = (2 * cfg.d_model * (cfg.n_heads + 2 * cfg.n_kv_heads)
                 * cfg.head_dim + 2 * 2 * cfg.encoder_seq * cfg.n_heads
                 * cfg.head_dim)
        total += tokens * cfg.n_layers * (dec_self + cross)
    elif cfg.family == "ssm":
        n_s = cfg.n_layers // cfg.slstm_every
        n_m = cfg.n_layers - n_s
        slstm = (2 * cfg.d_model * 4 * cfg.d_model
                 + 2 * cfg.d_model * 4 * (cfg.d_model // cfg.n_heads)
                 + 2 * cfg.d_model * cfg.d_model)
        total += tokens * (n_m * _mlstm_layer_flops(cfg) + n_s * slstm)
    elif cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.attn_every
        dense = _dense_layer_flops(cfg, s_ctx)
        total += tokens * (cfg.n_layers * _mamba_layer_flops(cfg)
                           + n_attn * dense)
    return float(total)


def _param_bytes(cfg) -> float:
    from ..models.transformer import param_shapes

    return float(sum(l.nbytes for l in param_shapes(cfg).values()))


def _act_bytes(cfg, s, batch, kind) -> float:
    """Residual-stream traffic + family extras (global, forward)."""
    act = 2  # bf16
    tokens = batch * (1 if kind == "decode" else s)
    layers = cfg.n_layers + cfg.encoder_layers
    res = 12 * tokens * cfg.d_model * act * layers
    extra = 0.0
    if cfg.family in ("dense", "moe", "vlm", "audio", "hybrid"):
        n_attn = (cfg.n_layers // cfg.attn_every
                  if cfg.family == "hybrid" else layers)
        if kind == "decode":
            # stream the KV cache once per step
            extra += (n_attn * batch * s * cfg.n_kv_heads * cfg.head_dim
                      * 2 * act)
        elif cfg.attention_impl == "reference":
            # materialized (S×S) scores: written + read twice (f32)
            extra += n_attn * batch * cfg.n_heads * s * s * 4 * 3
    if kind == "prefill":
        extra += batch * cfg.vocab_size * act           # last-only logits
    elif kind == "train":
        extra += 2 * tokens * cfg.vocab_size * (act + 4)  # logits + f32 loss
    elif kind == "decode":
        extra += batch * cfg.vocab_size * act
    return res + extra


def cell_estimate(cfg, shape) -> dict:
    """Global analytic flops + HBM bytes for one step of this cell."""
    from ..models.io import text_len

    kind = shape.kind
    b = shape.global_batch
    s = text_len(cfg, shape.seq_len) if kind != "decode" else shape.seq_len
    fwd = _fwd_flops(cfg, s, b, kind)
    p_bytes = _param_bytes(cfg)
    act = _act_bytes(cfg, s, b, kind)
    if kind == "train":
        remat_extra = 1 if cfg.remat == "full" else 0
        flops = fwd * (3 + remat_extra)
        # params: fwd + bwd + remat reads, grad f32 w/r, adam m/v r/w (f32),
        # param write
        n_params = p_bytes / 2 if cfg.dtype == "bfloat16" else p_bytes / 4
        bytes_ = (p_bytes * (2 + remat_extra)      # weight reads
                  + n_params * (8 + 16 + 2)        # grads f32, moments, write
                  + act * (2 + remat_extra))       # acts fwd + bwd (+ remat)
    else:
        flops = fwd
        bytes_ = p_bytes + act
    return {"flops": flops, "hbm_bytes": bytes_}
