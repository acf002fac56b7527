"""Plain-torch reference of the dense decoder the benchmark runs, in
float32, computed layer by layer so that a full-size model fits beside
nothing else on the card.

It follows the published description of a pre-norm decoder (LLaMA's,
which DeepSeek LLM keeps) and the semantics the configuration
file states: RMSNorm or LayerNorm (with bias) in float32 at ``norm_eps``;
rotary embeddings on the two halves of each head at ``rope_theta``;
causal softmax attention with scale ``head_dim ** -0.5``, query head
``h`` reading key/value head ``h // (n_heads / n_kv_heads)``; a SwiGLU
MLP ``(silu(x W1) * (x W3)) W2``; the final norm and the unembedding
``x W_head``.  Weights are ``(in, out)``: ``x @ w``.

It takes the weights the benchmark made (:mod:`cardbench.weights`), never
anything the program made, and imports nothing of the program.  Matrix
products run in true float32 (TF32 off) inside :func:`exact_f32`.

``quant="fp8"`` is the control: every linear layer's input and weight
rounded to float8 e4m3 (a scale for each input row and each weight
column), the rest as above, the precision below the configuration's
bf16 that a faster path would reach for.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["exact_f32", "fp8", "linear", "norm", "rope", "causal_attention",
           "block", "unembed", "Hidden", "first_choices", "served_gaps"]

_E4M3_MAX = 448.0
#: tokens of equal-length sequences that :class:`Hidden` runs through a
#: layer at once (the float32 activations of 32,768 tokens of a 7 B
#: model's MLP take about 1.4 GB a tensor)
CHUNK_TOKENS = 32768


@contextlib.contextmanager
def exact_f32():
    """Matrix products in true float32 (no TF32) inside, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (its largest magnitude maps to 448), back in float32.  The
    gradient passes straight through."""
    scale = t.detach().abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) \
        / _E4M3_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t).detach() if t.requires_grad else q


def linear(x: torch.Tensor, w: torch.Tensor, quant: Optional[str]
           ) -> torch.Tensor:
    """``x @ w`` in float32; under ``quant="fp8"`` both rounded first."""
    x, w = x.float(), w.float()
    if quant == "fp8":
        x, w = fp8(x, -1), fp8(w, 0)
    return x @ w


def supported(cfg: dict) -> None:
    """Raise for a configuration this reference does not compute: a
    partial rotary embedding or biased projections."""
    if cfg.get("partial_rotary_factor", 1.0) != 1.0 or cfg.get(
            "use_qkv_bias", False):
        raise NotImplementedError(
            f"{cfg['name']}: the reference rotates whole heads and has no "
            f"projection biases")


def norm(x: torch.Tensor, p: dict, kind: str, eps: float) -> torch.Tensor:
    x = x.float()
    if kind == "rmsnorm":
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
            * p["scale"].float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"].float() \
        + p["bias"].float()


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x (B, S, H, D) float32; the first half of each head rotated with
    the second by angle ``position * theta ** (-2 i / D)``."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32,
                                  device=x.device) / half)
    ang = positions.float()[..., None, None] * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_block: int = 0) -> torch.Tensor:
    """q (B, S, Hq, D), k/v (B, S, Hkv, D), float32 -> (B, S, Hq, D).
    Position i sees positions <= i.  ``q_block`` > 0 computes the scores
    that many query rows at a time."""
    b, s, hq, d = q.shape
    group = hq // k.shape[2]
    kt = k.repeat_interleave(group, dim=2).permute(0, 2, 3, 1)  # B H D S
    vt = v.repeat_interleave(group, dim=2).transpose(1, 2)      # B H S D
    qt = q.transpose(1, 2) * d ** -0.5                          # B H S D
    step = q_block or s
    out = []
    for lo in range(0, s, step):
        hi = min(s, lo + step)
        scores = qt[:, :, lo:hi] @ kt[..., :hi]
        rows = torch.arange(lo, hi, device=q.device)[:, None]
        cols = torch.arange(hi, device=q.device)[None, :]
        scores = scores.masked_fill(cols > rows, float("-inf"))
        out.append(torch.softmax(scores, dim=-1) @ vt[:, :, :hi])
    return torch.cat(out, dim=2).transpose(1, 2)


def block(cfg: dict, w: dict, x: torch.Tensor, positions: torch.Tensor,
          quant: Optional[str] = None, q_block: int = 0):
    """One pre-norm block on float32 ``x`` (B, S, D): returns the new
    ``x`` and the block's k and v heads (B, S, Hkv, D), k after RoPE."""
    b, s, _ = x.shape
    hq, hkv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    eps, theta = cfg["norm_eps"], cfg["rope_theta"]
    h = norm(x, w["ln1"], cfg["norm"], eps)
    q = rope(linear(h, w["wq"], quant).view(b, s, hq, hd), positions, theta)
    k = rope(linear(h, w["wk"], quant).view(b, s, hkv, hd), positions, theta)
    v = linear(h, w["wv"], quant).view(b, s, hkv, hd)
    a = causal_attention(q, k, v, q_block).reshape(b, s, hq * hd)
    x = x + linear(a, w["wo"], quant)
    h = norm(x, w["ln2"], cfg["norm"], eps)
    m = F.silu(linear(h, w["w1"], quant)) * linear(h, w["w3"], quant)
    return x + linear(m, w["w2"], quant), k, v


def unembed(cfg: dict, weights: dict, x: torch.Tensor,
            quant: Optional[str] = None) -> torch.Tensor:
    """Logits of hidden states ``x`` (..., D) after the final norm."""
    h = norm(x, weights["final_norm"], cfg["norm"], cfg["norm_eps"])
    head = weights["lm_head"]
    return linear(h, weights["embed"].T if head is None else head, quant)


class Hidden:
    """The last block's output of some sequences, and their k and v at
    chosen positions of every layer, computed a layer at a time over all
    of them (each layer's weights read once; sequences of one length go
    through together, up to :data:`CHUNK_TOKENS` tokens at a time)."""

    def __init__(self, cfg: dict, weights: dict, seqs: list,
                 kv_positions: Optional[list] = None,
                 quant: Optional[str] = None, q_block: int = 1024):
        """``seqs``: token-id tensors (S,) (any lengths); ``kv_positions``:
        for each sequence None or a 1-D tensor of positions whose k and v
        are kept (``self.kv[i]``: (L, 2, P, Hkv, D))."""
        supported(cfg)
        dev = weights["embed"].device
        keep = kv_positions or [None] * len(seqs)
        by_length: dict = {}
        for i, t in enumerate(seqs):
            by_length.setdefault(len(t), []).append(i)
        groups = []
        for length, idx in by_length.items():
            step = max(1, CHUNK_TOKENS // length)
            groups += [idx[j:j + step] for j in range(0, len(idx), step)]
        xs = [weights["embed"][torch.stack([seqs[i] for i in g]).to(dev)]
              .float() for g in groups]
        kv = [[] for _ in seqs]
        with exact_f32(), torch.no_grad():
            for w in weights["layers"]:
                w32 = {n: (t.float() if torch.is_tensor(t) else t)
                       for n, t in w.items()}
                for j, (g, x) in enumerate(zip(groups, xs)):
                    pos = torch.arange(x.shape[1], device=dev)[None]
                    xs[j], k, v = block(cfg, w32, x, pos, quant, q_block)
                    for row, i in enumerate(g):
                        if keep[i] is not None:
                            p = keep[i].to(dev)
                            kv[i].append(torch.stack([k[row, p], v[row, p]]))
                del w32
        self.x = [None] * len(seqs)
        for g, x in zip(groups, xs):
            for row, i in enumerate(g):
                self.x[i] = x[row]
        self.kv = [torch.stack(k) if k else None for k in kv]


def _logits_at(cfg, weights, hidden: Hidden, rows: list, quant):
    for x, r in zip(hidden.x, rows):
        yield unembed(cfg, weights, x[r.to(x.device)], quant)


def first_choices(cfg: dict, weights: dict, hidden: Hidden, rows: list,
                  quant: Optional[str] = None) -> list:
    """For each sequence ``i``, the token that ranks first at each of its
    positions ``rows[i]`` (a 1-D tensor), on the CPU."""
    with exact_f32(), torch.no_grad():
        return [logits.argmax(dim=-1).cpu() for logits in
                _logits_at(cfg, weights, hidden, rows, quant)]


def served_gaps(cfg: dict, weights: dict, hidden: Hidden, rows: list,
                tokens: list) -> list:
    """For each sequence ``i``, the gap by which each of ``tokens[i]``
    (the tokens served at its positions ``rows[i]``) lies below the best
    logit there."""
    out = []
    with exact_f32(), torch.no_grad():
        for logits, t in zip(_logits_at(cfg, weights, hidden, rows, None),
                             tokens):
            got = logits.gather(-1, t.to(logits.device).long()[:, None])
            out.append((logits.max(dim=-1).values - got[:, 0]).cpu())
    return out
