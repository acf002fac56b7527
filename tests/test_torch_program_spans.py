"""The LM path's spans (``repro_torch.core.obs.program_span``) on the
CPU: off, they enter no ``record_function``; under ``torch.profiler``
the dense model's calls and blocks and the trainer's update record the
registered ranges, nested as the code nests them."""

import ast
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.core import obs  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serving import ServeConfig, ServingEngine  # noqa: E402
from repro_torch.training import OptConfig, make_steps  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
NEW = 3


def serve(new: int = NEW):
    cfg = configs.reduced(configs.get_config("codeqwen1.5-7b"))
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    engine = ServingEngine(cfg, model, ServeConfig(max_len=16), device="cpu")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)
    return cfg, lambda: engine.generate(prompts, new)


def train():
    """A step of the reduced stablelm with its blocks recomputed in the
    backward."""
    cfg = configs.reduced(configs.get_config("stablelm-1.6b"), remat="full")
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    steps = make_steps(cfg, OptConfig())
    opt = steps["init_opt"](model)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16),
                                     generator=torch.Generator()
                                     .manual_seed(1))}
    return cfg, lambda: steps["train_step"](model, opt, batch)


def ranges(work) -> list:
    """(kind, start ns, end ns) of every program range ``work`` records
    under a CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        work()
    return [(e.name()[len(obs.PROGRAM_PREFIX):], e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith(obs.PROGRAM_PREFIX)]


def inside(got: list, outer: tuple) -> Counter:
    """The kinds of the ranges nested in ``outer``, counted."""
    return Counter(k for k, s, e in got
                   if (k, s, e) != outer and outer[1] <= s and e <= outer[2])


def test_without_a_profiler_no_range_is_entered(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert obs.program_span(obs.SPAN_DECODE_STEP) is obs.NULL_RANGE
    _, generate = serve()
    assert generate().shape == (2, NEW)
    _, step = train()
    _, _, metrics = step()
    assert torch.isfinite(metrics["loss"])


def test_a_decode_step_holds_each_blocks_ranges():
    cfg, generate = serve()
    got = ranges(generate)
    kinds = Counter(k for k, _, _ in got)
    assert kinds[obs.SPAN_DECODE_STEP] == NEW
    assert kinds[obs.SPAN_PREFILL] == 1
    n = cfg.n_layers
    per_pass = {obs.SPAN_ROPE: n, obs.SPAN_ATTEND: n, obs.SPAN_NORM: 2 * n}
    for outer in got:
        if outer[0] in (obs.SPAN_DECODE_STEP, obs.SPAN_PREFILL):
            assert inside(got, outer) == per_pass
        if outer[0] in (obs.SPAN_NORM, obs.SPAN_ROPE, obs.SPAN_ATTEND):
            assert inside(got, outer) == Counter()


def test_a_train_step_records_one_optimizer_range():
    cfg, step = train()
    got = ranges(step)
    kinds = Counter(k for k, _, _ in got)
    assert kinds[obs.SPAN_OPTIMIZER] == 1
    # the backward recomputes the blocks, which open their ranges again
    assert kinds[obs.SPAN_NORM] == 2 * 2 * cfg.n_layers
    assert obs.SPAN_PREFILL not in kinds
    (optimizer,) = [r for r in got if r[0] == obs.SPAN_OPTIMIZER]
    assert inside(got, optimizer) == Counter()
    # every block's norm comes before the update
    assert max(e for k, _, e in got if k == obs.SPAN_NORM) <= optimizer[1]


def test_every_span_is_registered():
    assert set(obs.PROGRAM_SPANS) <= obs.REGISTERED_NAMES
    assert len(set(obs.PROGRAM_SPANS)) == len(obs.PROGRAM_SPANS)
    recorded = {k for work in (serve()[1], train()[1]) for k, _, _ in
                ranges(work)}
    assert recorded == set(obs.PROGRAM_SPANS)


def test_every_site_names_a_registered_constant():
    sites = 0
    for path in SRC.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and getattr(
                    node.func, "id", None) == "program_span":
                (arg,) = node.args
                assert isinstance(arg, ast.Name), path
                assert getattr(obs, arg.id) in obs.PROGRAM_SPANS, path
                sites += 1
    assert sites >= len(obs.PROGRAM_SPANS)
