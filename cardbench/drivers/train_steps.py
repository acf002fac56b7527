"""Driver of pretraining steps: the port's ``make_steps(cfg,
opt_cfg)["train_step"]`` on batches the run draws from the seed, one
after the other, every row new.

The traffic file gives ``batch`` and ``seq`` (a step's rows and tokens a
row), ``checked_steps`` and ``optimizer`` (the port's ``OptConfig``:
AdamW, its clipping and its schedule).  Set-up builds the model and its
AdamW state once and drives that same object through the first
``checked_steps`` steps, reading what the check compares (each step's
loss, the first gradient as the optimizer's moments hold it, and how far
the steps moved each weight); the window then goes on training it.  A
step ends when its loss is on the host.  No checkpoint is written.
"""

from __future__ import annotations

import math
import time

from cardbench import checks, program
from cardbench import weights as W
from cardbench.reference import train as ref_train
from cardbench.trace import span


def _opt(run) -> dict:
    return run.traffic["optimizer"]


def prepare(run) -> dict:
    cfg, tr = run.cfg, run.traffic
    training = program.port("training")
    start = ref_train.leaves(W.make_weights(cfg, run.seed, run.device))
    names = list(start)
    model = program.build_model(cfg, start)
    del start
    o = dict(_opt(run))
    o["betas"] = tuple(o["betas"])
    steps = training.make_steps(program.model_config(cfg),
                                training.OptConfig(**o))
    st = {"model": model, "step": steps["train_step"],
          "opt": steps["init_opt"](model), "losses": [], "n": 0}
    b1 = o["betas"][0]
    for i in range(tr["checked_steps"]):
        _step(run, st)
        if i == 0:
            # m = (1 - b1) g after one step, g as the optimizer took it
            st["first_grad"] = {
                n: float(st["opt"]["m"][program.port_name(n)].norm())
                / (1 - b1) for n in names}
    params = dict(st["model"].named_parameters())
    start = ref_train.leaves(W.make_weights(cfg, run.seed, run.device))
    st["change"] = {n: float((params[program.port_name(n)].detach().float()
                              - t.float()).norm())
                    for n, t in start.items()}
    st["checked_losses"] = list(st["losses"])
    return st


def _batch(run, i: int) -> dict:
    tr = run.traffic
    return {"tokens": W.make_tokens(run.seed, i, tr["batch"], tr["seq"],
                                    run.cfg["vocab_size"], run.device)}


def _step(run, st: dict) -> None:
    with span("make_tokens"):
        batch = _batch(run, st["n"])
    with span("train_step"):
        st["model"], st["opt"], metrics = st["step"](st["model"], st["opt"],
                                                     batch)
    with span("loss_to_host"):
        st["losses"].append(float(metrics["loss"]))
    st["n"] += 1


def measure(run, st: dict, seconds: float) -> dict:
    t0 = time.perf_counter()
    first = st["n"]
    while st["n"] == first or time.perf_counter() - t0 < seconds:
        _step(run, st)
    window_s = time.perf_counter() - t0
    steps = st["n"] - first
    tr = run.traffic
    tokens = steps * tr["batch"] * tr["seq"]
    failed = sum(not math.isfinite(x) for x in st["losses"][first:])
    return {"e2e": {"train_tok_s": tokens / window_s},
            "attempted": steps, "failed": failed,
            "counters": {"window_s": window_s, "steps": steps}}


def trace_slice(run, st: dict) -> dict:
    for _ in range(run.traffic["traced_steps"]):
        _step(run, st)
    return {}


def release(run, st: dict) -> None:
    for key in ("model", "opt", "step"):
        st.pop(key, None)


def readings(st: dict) -> dict:
    """The program's readings, as the reference's train_steps gives its
    own."""
    return {"losses": st["checked_losses"], "first_grad": st["first_grad"],
            "change": st["change"]}


def compare(run, st: dict, quant: str | None = None,
            half: bool = False) -> dict:
    """The program's readings against the reference's; with ``quant``
    the reference at that precision stands in for the program, and with
    ``half`` the reference on the first half of each batch's rows, the
    mean taken over them."""
    weights = W.make_weights(run.cfg, run.seed, run.device)
    batches = [_batch(run, i)["tokens"]
               for i in range(run.traffic["checked_steps"])]
    want = ref_train.train_steps(run.cfg, _opt(run), weights, batches)
    if quant is None and not half:
        got = readings(st)
    else:
        got = ref_train.train_steps(
            run.cfg, _opt(run), weights,
            [b[:len(b) // 2] for b in batches] if half else batches, quant)
    return checks.train_numbers(got, want)
