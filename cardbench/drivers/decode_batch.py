"""Driver of offline batch generation: whole batches of prompts, each
generated to a fixed number of greedy tokens by the port's
``ServingEngine.generate``, back to back.

The traffic file gives ``rows`` and ``prompt`` (a batch's prompts),
``new_tokens`` (greedy tokens a row) and ``check_rows`` (finished rows
the check runs through the reference).  The window ends with the first
batch that ends after ``--seconds``; its rate counts every generated
token over the whole window, prefills included.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from cardbench import checks, program
from cardbench import weights as W
from cardbench.reference.train import leaves
from cardbench.trace import span

#: token draws of the warm-up batch (the window's start at 0)
_WARM = 1 << 30


def prepare(run) -> dict:
    cfg, tr = run.cfg, run.traffic
    serving = program.port("serving")
    model = program.build_model(
        cfg, leaves(W.make_weights(cfg, run.seed, run.device)))
    engine = serving.ServingEngine(
        program.model_config(cfg), model,
        serving.ServeConfig(max_len=tr["prompt"] + tr["new_tokens"]),
        device=run.device)
    st = {"model": model, "engine": engine, "done": []}
    # the prefill's shape and the decode step's (the same at every
    # position: the step reads the whole cache)
    _batch(run, st, _WARM, new=2)
    return st


def _batch(run, st: dict, index: int, new: int) -> tuple:
    tr = run.traffic
    with span("make_prompts"):
        prompts = W.make_tokens(run.seed, index, tr["rows"], tr["prompt"],
                                run.cfg["vocab_size"], run.device)
        host = prompts.cpu().numpy()
    with span("generate"):
        out = st["engine"].generate(host, new)
    return host, out


def measure(run, st: dict, seconds: float) -> dict:
    tr = run.traffic
    engine = st["engine"]
    before = engine.stats
    t0 = time.perf_counter()
    n = 0
    while n == 0 or time.perf_counter() - t0 < seconds:
        st["done"].append(_batch(run, st, n, tr["new_tokens"]))
        n += 1
    window_s = time.perf_counter() - t0
    after = engine.stats
    vocab = run.cfg["vocab_size"]
    failed = sum(int(((out < 0) | (out >= vocab)).any(axis=1).sum())
                 for _, out in st["done"])
    tokens = n * tr["rows"] * tr["new_tokens"]
    return {"e2e": {"output_tok_s": tokens / window_s},
            "attempted": n * tr["rows"], "failed": failed,
            "counters": {"window_s": window_s, "batches": n,
                         "decode_steps": n * tr["new_tokens"],
                         "decode_s": after["decode_s"] - before["decode_s"],
                         "prefill_s": after["prefill_s"]
                         - before["prefill_s"]}}


def trace_slice(run, st: dict) -> dict:
    """One batch after the window (kept out of the check)."""
    _batch(run, st, len(st["done"]), run.traffic["new_tokens"])
    return {}


def release(run, st: dict) -> None:
    for key in ("model", "engine"):
        st.pop(key, None)


def compare(run, st: dict, quant: str | None = None) -> dict:
    tr = run.traffic
    rows = [{"length": tr["prompt"] + tr["new_tokens"], "batch": b, "row": r}
            for b in range(len(st["done"])) for r in range(tr["rows"])]
    picked = checks.sample_rows(run.seed, rows, tr["check_rows"])
    weights = W.make_weights(run.cfg, run.seed, run.device)
    rows = [{"prompt": torch.as_tensor(st["done"][p["batch"]][0][p["row"]]),
             "served": torch.as_tensor(np.asarray(
                 st["done"][p["batch"]][1][p["row"]], dtype=np.int64))}
            for p in picked]
    return checks.decode_numbers(run.cfg, weights, rows, quant)
