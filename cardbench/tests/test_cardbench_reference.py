"""The plain reference computes what the program computes: at a tiny size
in float32 on the CPU, the port's prefill logits and cache and its
AdamW steps agree with the reference's on the benchmark's weights; the
float8 control does not."""

from __future__ import annotations

import json

import pytest
import torch

import cardbench_tiny as tiny
from cardbench import program, weights
from cardbench.reference import dense_lm
from cardbench.reference import train as ref_train

HERE = tiny.ROOT / "cardbench"


def tiny_config(name: str, **kw) -> dict:
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    return dict(cfg, **dict(tiny.TINY, dtype="float32", **kw))


def train_traffic() -> dict:
    return json.loads((HERE / "traffic" / "train_2k.json").read_text())


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_prefill_logits_and_cache_agree_with_the_port(norm):
    from repro_torch.models import prefill

    cfg = tiny_config("deepseek-llm-7b", norm=norm)
    w = weights.make_weights(cfg, 2 ** 31 + 3, "cpu")
    model = program.build_model(cfg, ref_train.leaves(w))
    tokens = weights.make_tokens(7, 0, 3, 20, cfg["vocab_size"], "cpu")
    logits, cache = prefill(program.model_config(cfg), model,
                            {"tokens": tokens}, 21)
    pos = torch.tensor([0, 7, 19])
    hid = dense_lm.Hidden(cfg, w, list(tokens), [pos] * 3, q_block=8)
    last = [torch.tensor([19])] * 3
    with torch.no_grad():
        for i in range(3):
            got = dense_lm.unembed(cfg, w, hid.x[i][last[i]])
            assert torch.allclose(got, logits[i].float(), atol=1e-5)
            kv = torch.stack([cache["k"][:, i, pos], cache["v"][:, i, pos]], 1)
            assert torch.allclose(hid.kv[i], kv, atol=1e-5)
    firsts = dense_lm.first_choices(cfg, w, hid, last)
    assert [int(f) for f in firsts] == logits[:, 0].argmax(-1).tolist()
    gaps = dense_lm.served_gaps(cfg, w, hid, last, firsts)
    assert all(float(g) == 0.0 for g in gaps)


def test_training_steps_agree_with_the_port():
    import repro_torch.training as training

    cfg = tiny_config("deepseek-llm-7b", norm="layernorm",
                      attention_impl="reference")
    o = train_traffic()["optimizer"]
    opt = dict(o, betas=tuple(o["betas"]))
    w = weights.make_weights(cfg, 11, "cpu")
    start = ref_train.leaves(w)
    model = program.build_model(cfg, {n: t.clone() for n, t in start.items()})
    steps = training.make_steps(program.model_config(cfg),
                                training.OptConfig(**opt))
    state = steps["init_opt"](model)
    batches = [weights.make_tokens(11, i, 2, 16, cfg["vocab_size"], "cpu")
               for i in range(3)]
    losses = []
    for i, b in enumerate(batches):
        model, state, m = steps["train_step"](model, state, {"tokens": b})
        losses.append(float(m["loss"]))
        if i == 0:
            first = {n: float(state["m"][program.port_name(n)].norm())
                     / (1 - opt["betas"][0]) for n in start}
    params = dict(model.named_parameters())
    want = ref_train.train_steps(cfg, opt, w, batches)
    assert losses == pytest.approx(want["losses"], rel=1e-5)
    for n in start:
        assert first[n] == pytest.approx(want["first_grad"][n], rel=1e-3,
                                         abs=1e-7)
        moved = float((params[program.port_name(n)].detach()
                       - start[n]).norm())
        assert moved == pytest.approx(want["change"][n], rel=1e-3, abs=1e-7)


@pytest.mark.parametrize("step", [0, 1, 2, 3, 500, 1000, 2000])
def test_learning_rate_follows_the_ports(step):
    from repro_torch.training.optimizer import OptConfig, lr_at

    o = train_traffic()["optimizer"]
    o = dict(o, betas=tuple(o["betas"]))
    assert ref_train.lr_at(o, step) == pytest.approx(
        float(lr_at(OptConfig(**o), step)), rel=1e-6)


def test_float8_control_rounds_and_passes_the_gradient():
    x = torch.randn(8, 64, generator=torch.Generator().manual_seed(0))
    x.requires_grad_(True)
    q = dense_lm.fp8(x, -1)
    rel = float((q - x).detach().norm() / x.detach().norm())
    assert 0.005 < rel < 0.06
    assert torch.equal(dense_lm.fp8(q.detach(), -1), q.detach())
    q.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))


def test_a_configuration_the_reference_does_not_compute_is_refused():
    cfg = tiny_config("deepseek-llm-7b", partial_rotary_factor=0.25)
    with pytest.raises(NotImplementedError):
        dense_lm.Hidden(cfg, weights.make_weights(cfg, 1, "cpu"),
                        [torch.zeros(4, dtype=torch.long)])
