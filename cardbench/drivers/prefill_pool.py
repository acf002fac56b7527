"""Driver of prefill-pool traffic: batches of prompts prefilled back to
back (a closed loop of one client that sends its next batch when the
last one's first tokens are on the host), each stopping at its first
token.

The traffic file gives ``batches``: a cycle of ``{"rows", "length"}``
that the run repeats in order (the seed draws only the token ids, so
every seed serves the same lengths in the same order); ``check_rows``,
how many finished requests the check runs through the reference (one of
the longest, the rest of the shortest: ``checks.sample_rows``); and
``digest_positions``, how many positions of each prompt's KV cache the
run keeps (on the host, after the first token) for the check.  The
window ends at the first end of a whole cycle after ``--seconds``, so
that every run serves the same mix and its 95th percentile falls on the
same batch shape however fast the batches go.

Each batch calls the port's ``models.prefill`` with a cache sized to it
(``max_len`` = length + 1) and the serving engine's greedy sampling, as
``ServingEngine.generate`` does before its first decode step.  A row's
time to first token runs from its batch's start to its token on the
host.
"""

from __future__ import annotations

import math
import time

import torch

from cardbench import checks, program
from cardbench import weights as W
from cardbench.reference.train import leaves
from cardbench.trace import span

#: token draws of the warm-up batches start here (the window's at 0)
_WARM = 1 << 30


def _cycle(run) -> list:
    return [(b["rows"], b["length"]) for b in run.traffic["batches"]]


def prepare(run) -> dict:
    cfg = run.cfg
    serving, models = program.port("serving"), program.port("models")
    model = program.build_model(
        cfg, leaves(W.make_weights(cfg, run.seed, run.device)))
    mc = program.model_config(cfg)
    longest = max(length for _, length in _cycle(run))
    if longest > cfg.get("max_position_embeddings", longest):
        raise ValueError(f"{cfg['name']} holds "
                         f"{cfg['max_position_embeddings']} positions; the "
                         f"traffic sends {longest}")
    st = {"model": model, "mc": mc, "prefill": models.prefill,
          "engine": serving.ServingEngine(
              mc, model, serving.ServeConfig(max_len=longest + 1),
              device=run.device),
          "gen": torch.Generator(device=run.device).manual_seed(0),
          "kept": [], "batches": []}
    for j, shape in enumerate(sorted(set(_cycle(run)))):
        _batch(run, st, _WARM + j, shape, keep=False)
    return st


def _batch(run, st: dict, index: int, shape: tuple, keep: bool) -> float:
    """One batch; returns its time to first token."""
    rows, length = shape
    with span("make_tokens"):
        tokens = W.make_tokens(run.seed, index, rows, length,
                               run.cfg["vocab_size"], run.device)
    t0 = time.perf_counter()
    with span("prefill"):
        logits, cache = st["prefill"](st["mc"], st["model"],
                                      {"tokens": tokens}, length + 1)
    with span("sample"):
        # the engine's greedy choice of each row's next token
        first = st["engine"]._sample(logits, st["gen"])
    with span("first_token"):
        first = first[:, 0].cpu()
    ttft = time.perf_counter() - t0
    with span("cache_digest"):
        pos = checks.digest_positions(run.seed, index, length,
                                      run.traffic["digest_positions"])
        at = torch.as_tensor(pos, device=run.device)
        kv = torch.stack([cache["k"].index_select(2, at),
                          cache["v"].index_select(2, at)], 1).cpu()
    del logits, cache
    if keep:
        st["batches"].append((rows, length, ttft))
        for r in range(rows):
            st["kept"].append({"index": index, "row": r, "length": length,
                               "tokens": tokens[r], "first": int(first[r]),
                               "positions": pos, "kv": kv[:, :, r]})
    return ttft


def measure(run, st: dict, seconds: float) -> dict:
    cycle = _cycle(run)
    t0 = time.perf_counter()
    n = 0
    while n == 0 or time.perf_counter() - t0 < seconds:
        for shape in cycle:
            _batch(run, st, n, shape, keep=True)
            n += 1
    window_s = time.perf_counter() - t0
    ttfts = sorted(t for rows, _, t in st["batches"] for _ in range(rows))
    vocab = run.cfg["vocab_size"]
    failed = sum(not 0 <= r["first"] < vocab for r in st["kept"])
    return {"e2e": {"ttft_p95_s": ttfts[math.ceil(0.95 * len(ttfts)) - 1]},
            "attempted": len(ttfts), "failed": failed,
            "counters": {"window_s": window_s, "batches": n,
                         "prefills": [(rows, length)
                                      for rows, length, _ in st["batches"]]}}


def trace_slice(run, st: dict) -> dict:
    """One cycle of the traffic, after the window (kept out of the
    check); returns the flash calls it should make and the launches the
    port counted."""
    cycle = _cycle(run)
    first = len(st["batches"])
    before = program.flash_launches()
    for j, shape in enumerate(cycle):
        _batch(run, st, first + j, shape, keep=False)
    cfg = run.cfg
    calls = [(rows, cfg["n_heads"], cfg["n_kv_heads"], length, length,
              cfg["head_dim"]) for rows, length in cycle
             for _ in range(cfg["n_layers"])]
    return {"flash_calls": calls,
            "flash_launches": program.flash_launches() - before}


def release(run, st: dict) -> None:
    for key in ("model", "engine", "prefill"):
        st.pop(key, None)


def compare(run, st: dict, quant: str | None = None) -> dict:
    rows = checks.sample_rows(run.seed, st["kept"], run.traffic["check_rows"])
    weights = W.make_weights(run.cfg, run.seed, run.device)
    return checks.prefill_numbers(run.cfg, weights, rows, quant)
