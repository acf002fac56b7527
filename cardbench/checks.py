"""What decides ``correct``: the numbers each kind of cell compares with
the plain reference (:mod:`cardbench.reference`), and the judgement of
those numbers against the cell's limits.

Served cells.  A sample of the window's finished requests, drawn from
the seed, one of the longest and the rest of the shortest (whose
reference is cheap), is run through the reference in float32 once,
prompt and served tokens together.  For each served token the gap by
which its reference logit lies below the reference's best logit at that
position is read: 0 where the program served the reference's first
choice, small where rounding swapped two near-equal logits.  The widest
gap is compared.  The prefill pool also compares the KV cache the
prefill left, at positions drawn from the seed in every layer: each
layer's k and v against the reference's, as the norm of the difference
over the norm of the reference's.

Training.  Each of the first three steps' loss, the first gradient as
the optimizer took it (after clipping) weight by weight, and how far
three steps moved each weight, all against the reference's AdamW steps
from the same weights on the same batches.  A norm is compared by the
gap between the program's and the reference's, over the larger of the
reference's norm of that weight and the median weight's; weights whose
reference gradient is below a thousandth of the median weight's are
left out, since AdamW moves them by round-off alone.

The controls (:mod:`cardbench.calibrate`) put the reference in the
program's place, in float8: they read the same numbers.
"""

from __future__ import annotations

import math
import random
import statistics

import torch

from .reference import dense_lm
from .weights import group_seed

__all__ = ["judge", "sample_rows", "digest_positions", "prefill_numbers",
           "decode_numbers", "train_numbers", "NEGLIGIBLE_GRAD"]

#: a weight whose reference gradient norm is below this share of the
#: median weight's is left out of the training comparison
NEGLIGIBLE_GRAD = 1e-3
#: group index of the check's draws (past the weights' and tokens')
_CHECK = 1 << 40


def judge(numbers: dict, limits: dict) -> tuple:
    """(every limited number finite and at most its limit, {name:
    {"value", "limit"}} in the limits' order)."""
    compared, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        compared[name] = {"value": value, "limit": limit}
    return ok, compared


def sample_rows(seed: int, rows: list, k: int) -> list:
    """``k`` of ``rows`` (dicts with a ``"length"``), drawn from the seed:
    one of the longest, then others of the shortest length at random
    (where every row is as long, any)."""
    rng = random.Random(group_seed(seed, _CHECK))
    longest = max(r["length"] for r in rows)
    shortest = min(r["length"] for r in rows)
    first = rng.choice([i for i, r in enumerate(rows)
                        if r["length"] == longest])
    rest = [i for i, r in enumerate(rows)
            if i != first and r["length"] == shortest]
    picked = [first] + rng.sample(rest, min(k - 1, len(rest)))
    return [rows[i] for i in sorted(picked)]


def digest_positions(seed: int, index: int, length: int, n: int) -> list:
    """``n`` positions of a prompt of ``length`` drawn from the seed for
    batch ``index``, its last position among them."""
    rng = random.Random(group_seed(seed, _CHECK + 1 + index))
    pos = {length - 1}
    while len(pos) < min(n, length):
        pos.add(rng.randrange(length))
    return sorted(pos)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def prefill_numbers(cfg: dict, weights: dict, rows: list,
                    quant: str | None = None) -> dict:
    """The prefill pool's numbers over ``rows`` (dicts of ``tokens`` (L,),
    ``first`` (the served first token), ``positions`` and ``kv`` (L, 2,
    P, Hkv, D): the cache the program left there).  With ``quant`` the
    reference at that precision stands in for the program."""
    seqs = [r["tokens"] for r in rows]
    pos = [torch.as_tensor(r["positions"]) for r in rows]
    last = [torch.tensor([len(s) - 1]) for s in seqs]
    ref = dense_lm.Hidden(cfg, weights, seqs, pos)
    if quant is None:
        served = [torch.tensor([int(r["first"])]) for r in rows]
        kv = [r["kv"] for r in rows]
    else:
        low = dense_lm.Hidden(cfg, weights, seqs, pos, quant=quant)
        served = dense_lm.first_choices(cfg, weights, low, last, quant)
        kv = low.kv
        del low
    gaps = dense_lm.served_gaps(cfg, weights, ref, last, served)
    rel = max(_rel(got[layer, j], want[layer, j].to(got.device))
              for got, want in zip(kv, ref.kv)
              for layer in range(want.shape[0]) for j in (0, 1))
    return {"first_token_gap": max(float(g.max()) for g in gaps),
            "kv_cache_rel_err": rel}


def decode_numbers(cfg: dict, weights: dict, rows: list,
                   quant: str | None = None) -> dict:
    """The decode batch's number over ``rows`` (dicts of ``prompt`` (P,)
    and ``served`` (N,)): every served token's gap in the reference run
    over the prompt and the tokens served before it.  With ``quant`` the
    reference at that precision picks the tokens instead, at the same
    positions of the same sequences."""
    seqs = [torch.cat([r["prompt"], r["served"][:-1]]) for r in rows]
    at = [torch.arange(len(r["prompt"]) - 1, len(s)) for r, s in
          zip(rows, seqs)]
    served = [r["served"] for r in rows]
    if quant is not None:
        low = dense_lm.Hidden(cfg, weights, seqs, quant=quant)
        served = dense_lm.first_choices(cfg, weights, low, at, quant)
        del low
    ref = dense_lm.Hidden(cfg, weights, seqs)
    gaps = dense_lm.served_gaps(cfg, weights, ref, at, served)
    return {"decode_token_gap": max(float(g.max()) for g in gaps)}


def _norm_gap(got: dict, want: dict, keep: list) -> float:
    """The worst weight's |got - want| over max(want, the median
    weight's want), over the weights ``keep`` names."""
    med = statistics.median(want[n] for n in keep)
    return max(abs(got[n] - want[n]) / max(want[n], med) for n in keep)


def train_numbers(got: dict, want: dict) -> dict:
    """The training cell's numbers: ``got`` (the program's or a stand-in's
    readings) against ``want`` (the float32 reference's), both as
    :func:`cardbench.reference.train.train_steps` returns them."""
    grads = want["first_grad"]
    med = statistics.median(grads.values())
    keep = [n for n, g in grads.items() if g >= NEGLIGIBLE_GRAD * med]
    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(got["losses"], want["losses"])),
        "first_grad_gap": _norm_gap(got["first_grad"], grads, keep),
        "change_gap": _norm_gap(got["change"], want["change"], keep),
        "weights_left_out": len(grads) - len(keep),
    }
