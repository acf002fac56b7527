"""The benchmark's fixed arithmetic: the card's peaks and the operations a
step needs, computed from a configuration file's widths alone.

It lives under the benchmark so that it does not move when the program
does.  The dense forward count is copied from the port's
``launch/estimate.py`` (``_dense_layer_flops`` and the dense branch of
``_fwd_flops``); the causal attention count is the one the port's
``chip_smoke.py`` gives the flash kernel (``l (l + 1) / 2`` visible
pairs, a ``d``-long dot product and a ``d``-long weighted sum each); the
training count is the one ``chip_smoke.py`` reports its MFU from (6 N
tokens + 12 L B S^2 H hd).
"""

from __future__ import annotations

__all__ = [
    "PEAK_BF16_FLOP_S", "HBM_BYTES_S", "causal_attention_flops",
    "attention_bytes", "attention_roofline_s", "prefill_flops",
    "train_flops", "matmul_params",
]

#: NVIDIA H100 SXM data sheet, dense bf16 on the tensor cores, at 700 W
PEAK_BF16_FLOP_S = 989e12
#: the same sheet's HBM3 bandwidth
HBM_BYTES_S = 3.35e12


def causal_attention_flops(b: int, h: int, lq: int, lk: int, d: int) -> float:
    """Operations of causal attention with the mask aligned to the end of
    the keys (row ``r`` sees columns ``<= r + lk - lq``): each visible
    (row, column) pair is a ``d``-long q.k and a ``d``-long p.v, two
    operations a term."""
    # row r sees max(0, r + lk - lq + 1) columns, never more than lk
    off = lk - lq
    if off >= 0:
        pairs = lq * (off + 1) + lq * (lq - 1) // 2
    else:
        pairs = lk * (lk + 1) // 2
    return float(b * h * pairs * 4 * d)


def attention_bytes(b: int, hq: int, hkv: int, lq: int, lk: int, d: int
                    ) -> float:
    """Bytes bf16 attention must move: q, k and v read once, the output
    written once."""
    return float(2 * d * b * (2 * hq * lq + 2 * hkv * lk))


def attention_roofline_s(b: int, hq: int, hkv: int, lq: int, lk: int,
                         d: int) -> float:
    """The least time of one causal bf16 attention call on the card: the
    larger of its operations at the bf16 peak and its bytes at HBM's."""
    return max(causal_attention_flops(b, hq, lq, lk, d) / PEAK_BF16_FLOP_S,
               attention_bytes(b, hq, hkv, lq, lk, d) / HBM_BYTES_S)


def _dense_layer_flops(cfg: dict, s_ctx: float) -> float:
    """Forward operations a token of one dense block (``estimate.py``)."""
    d, f = cfg["d_model"], cfg["d_ff"]
    hq, hkv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    proj = 2 * d * (hq + 2 * hkv) * hd + 2 * hq * hd * d
    scores = 2 * 2 * s_ctx * hq * hd          # QK^T + PV over context
    mlp = 2 * 3 * d * f
    return proj + scores + mlp


def prefill_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model operations of one prefill of ``batch`` rows of ``seq``
    tokens: every block at half the context (causal) and the last
    position unembedded (``estimate._fwd_flops``, kind ``prefill``)."""
    head = 2 * cfg["d_model"] * cfg["vocab_size"] * batch
    return float(head + batch * seq * cfg["n_layers"]
                 * _dense_layer_flops(cfg, seq / 2))


def matmul_params(cfg: dict) -> int:
    """Weights of the model but the input embedding (a lookup): the
    blocks' projections and norms, the final norm and the head."""
    d, f = cfg["d_model"], cfg["d_ff"]
    hq, hkv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    norm = d * (2 if cfg["norm"] == "layernorm" else 1)
    block = d * hq * hd + 2 * d * hkv * hd + hq * hd * d + 3 * d * f \
        + 2 * norm
    head = 0 if cfg["tied_embeddings"] else d * cfg["vocab_size"]
    return cfg["n_layers"] * block + norm + head


def train_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model operations of one training step: 6 N tokens, plus the
    attention's 12 L B S^2 H hd (scores and P.V, forward and backward,
    over the whole square the plain attention computes)."""
    return (6.0 * matmul_params(cfg) * batch * seq
            + 12.0 * cfg["n_layers"] * batch * seq ** 2 * cfg["n_heads"]
            * cfg["head_dim"])
