"""Weights and token ids made from ``--seed``, on the device the run uses.

The same seed gives the same bits on every run.  Each group of weights
(the embedding, one block's seven matrices, the head) is one
``torch.randn`` call on a ``torch.Generator`` of that device, in the
dtype the model is served in, seeded from the run's seed and the
group's index, so that a group can be made again alone (the training
check makes a block's starting weights again to measure how far three
steps moved them).  Each matrix is a view of its group's buffer, scaled
to a fan-in normal (``fan_in ** -0.5``; the embedding 0.02).  Norm
scales are ones and layer-norm biases zeros, in float32, as the port
keeps them.

Both sides take these tensors: :mod:`cardbench.program` loads them into
the port's model, and :mod:`cardbench.reference` reads them.
"""

from __future__ import annotations

import torch

__all__ = ["BLOCK_MATRICES", "make_weights", "make_block", "make_tokens",
           "group_seed"]

#: a block's matrices, in the order its group lays them out
BLOCK_MATRICES = ("wq", "wk", "wv", "wo", "w1", "w3", "w2")
_MASK = (1 << 63) - 1
#: first group index of the token draws, past any model's weight groups
_TOKEN_GROUPS = 1 << 20


def group_seed(seed: int, index: int) -> int:
    """A 63-bit seed for group ``index`` of run ``seed`` (any whole
    number, however large)."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + (index + 1) * 0xBF58476D1CE4E5B9)
    x &= _MASK
    x ^= x >> 31
    return (x * 0x94D049BB133111EB) & _MASK


def _dtype(cfg: dict) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["dtype"]]


def _shapes(cfg: dict) -> dict:
    d, f = cfg["d_model"], cfg["d_ff"]
    hq, hkv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    return {"wq": (d, hq * hd), "wk": (d, hkv * hd), "wv": (d, hkv * hd),
            "wo": (hq * hd, d), "w1": (d, f), "w3": (d, f), "w2": (f, d)}


def _normal(seed: int, index: int, n: int, dtype, device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(group_seed(seed, index))
    return torch.randn(n, generator=g, dtype=dtype, device=device)


def _norm(cfg: dict, device) -> dict:
    d = cfg["d_model"]
    out = {"scale": torch.ones(d, dtype=torch.float32, device=device)}
    if cfg["norm"] == "layernorm":
        out["bias"] = torch.zeros(d, dtype=torch.float32, device=device)
    return out


def make_block(cfg: dict, seed: int, i: int, device) -> dict:
    """Block ``i``'s matrices (views of one buffer) and norms."""
    shapes = _shapes(cfg)
    sizes = [shapes[n][0] * shapes[n][1] for n in BLOCK_MATRICES]
    buf = _normal(seed, 2 + i, sum(sizes), _dtype(cfg), device)
    out, at = {}, 0
    for name, size in zip(BLOCK_MATRICES, sizes):
        w = buf[at:at + size].view(shapes[name])
        out[name] = w.mul_(shapes[name][0] ** -0.5)
        at += size
    out["ln1"], out["ln2"] = _norm(cfg, device), _norm(cfg, device)
    return out


def make_weights(cfg: dict, seed: int, device) -> dict:
    """Every weight of a dense model: ``{"embed", "layers": [block, ...],
    "final_norm", "lm_head"}`` (``lm_head`` None where the embedding is
    tied)."""
    d, v = cfg["d_model"], cfg["vocab_size"]
    dt = _dtype(cfg)
    embed = _normal(seed, 0, v * d, dt, device).view(v, d).mul_(0.02)
    head = None
    if not cfg["tied_embeddings"]:
        head = _normal(seed, 1, d * v, dt, device).view(d, v).mul_(d ** -0.5)
    return {"embed": embed,
            "layers": [make_block(cfg, seed, i, device)
                       for i in range(cfg["n_layers"])],
            "final_norm": _norm(cfg, device), "lm_head": head}


def make_tokens(seed: int, index: int, rows: int, length: int, vocab: int,
                device) -> torch.Tensor:
    """Token ids of batch ``index``: (rows, length) int64, uniform over
    the vocabulary."""
    g = torch.Generator(device=device).manual_seed(
        group_seed(seed, _TOKEN_GROUPS + index))
    return torch.randint(0, vocab, (rows, length), generator=g,
                         device=device)
