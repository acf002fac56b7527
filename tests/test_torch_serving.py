"""The port's serving engine against the JAX package's on the CPU.

Greedy generation must give the reference's tokens, token for token, on
``reduced(codeqwen1.5-7b)`` with the same weights (carried across with
``params_from_jax``) and ``attention_impl="pallas"`` (JAX's flash kernel
in interpret mode, the port's plain version).  Logits agree within 1e-4
in f32."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.serving import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402
from repro_torch.models import (  # noqa: E402
    decode_step, fill_cache, forward, init_cache, init_params,
    params_from_jax, prefill,
)
from repro_torch.serving import ServeConfig, ServingEngine  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ARCH = "codeqwen1.5-7b"


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, jax params, port cfg, port model) with equal weights."""
    jcfg = jax_configs.reduced(jax_configs.get_config(ARCH),
                               attention_impl="pallas")
    tcfg = configs.reduced(configs.get_config(ARCH), attention_impl="pallas")
    params = jax_tf.init_params(jcfg, jax.random.key(0))
    model = params_from_jax(
        tcfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return jcfg, params, tcfg, model


def prompts(seed: int, batch: int, length: int, vocab: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, vocab, (batch, length)).astype(np.int32)


def test_greedy_generate_equals_jax_engine(pair):
    jcfg, params, tcfg, model = pair
    p = prompts(0, 2, 24, tcfg.vocab_size)
    want = JaxServingEngine(jcfg, params, JaxServeConfig(max_len=32)
                            ).generate(p, 8)
    before = dict(ref.counts), dict(ops.counts)
    eng = ServingEngine(tcfg, model, ServeConfig(max_len=32), device="cpu")
    got = eng.generate(p, 8)
    assert got.dtype == np.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(got, np.asarray(want))
    # the CPU path ran the plain version, once per layer of the prefill
    assert ref.counts["flash_attention"] == (
        before[0]["flash_attention"] + tcfg.n_layers)
    assert ops.counts == before[1]


def test_generate_times_new_tokens_decode_steps(pair, monkeypatch):
    """As the reference's engine, ``generate`` runs one decode step per new
    token, the last one's logits unused, and ``decode_s`` covers them
    all; prompt + new tokens may fill ``max_len`` exactly."""
    from repro_torch.serving import engine as engine_mod

    jcfg, params, tcfg, model = pair
    p = prompts(4, 2, 24, tcfg.vocab_size)
    want = JaxServingEngine(jcfg, params, JaxServeConfig(max_len=32)
                            ).generate(p, 8)
    steps = []

    def counted(*args, **kw):
        steps.append(args[2]["pos"])
        return decode_step(*args, **kw)

    monkeypatch.setattr(engine_mod, "decode_step", counted)
    eng = ServingEngine(tcfg, model, ServeConfig(max_len=32), device="cpu")
    got = eng.generate(p, 8)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert steps == list(range(24, 32))
    assert eng.stats["tokens"] == 16 and eng.stats["decode_s"] > 0


def test_prefill_logits_and_cache_equal_jax(pair):
    jcfg, params, tcfg, model = pair
    p = prompts(1, 2, 24, tcfg.vocab_size)
    jlogits = jax_tf.forward(jcfg, params, {"tokens": jnp.asarray(p)})
    jcache = jax_tf.fill_cache(jcfg, params, {"tokens": jnp.asarray(p)},
                               jax_tf.init_cache(jcfg, 2, 32))
    logits, cache = prefill(tcfg, model, {"tokens": torch.from_numpy(p)}, 32)
    assert logits.shape == (2, 1, tcfg.vocab_size) and cache["pos"] == 24
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits)[:, -1:],
                               rtol=1e-4, atol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]),
                                   rtol=1e-4, atol=1e-4)
    filled = fill_cache(tcfg, model, {"tokens": torch.from_numpy(p)},
                        init_cache(tcfg, 2, 32, device="cpu"))
    assert torch.equal(filled["k"], cache["k"]) and filled["pos"] == 24


def test_prefill_then_decode_matches_full_forward(pair):
    """The serving path (prefill cache + decode steps) gives the logits
    of the full forward over the whole sequence."""
    _, _, tcfg, model = pair
    toks = torch.from_numpy(prompts(0, 1, 12, tcfg.vocab_size))
    full = forward(tcfg, model, {"tokens": toks})
    cache = fill_cache(tcfg, model, {"tokens": toks[:, :8]},
                       init_cache(tcfg, 1, 16, device="cpu"))
    for i in range(8, 12):
        logits, cache = decode_step(tcfg, model, cache, toks[:, i:i + 1])
    np.testing.assert_allclose(logits[0, 0].numpy(), full[0, 11].numpy(),
                               rtol=2e-4, atol=2e-4)
    assert cache["pos"] == 12


def test_engine_stats(pair):
    _, _, tcfg, model = pair
    eng = ServingEngine(tcfg, model, ServeConfig(max_len=32), device="cpu")
    p = prompts(2, 2, 8, tcfg.vocab_size)
    eng.generate(p, 5)
    eng.generate(p, 3)
    assert eng.stats["tokens"] == 16
    assert eng.stats["prefill_s"] > 0 and eng.stats["decode_s"] > 0
    assert eng.tokens_per_s > 0
    assert set(eng.metrics.snapshot()) == {"prefill_s", "decode_s", "tokens"}


def test_seeded_sampling_is_deterministic(pair):
    _, _, tcfg, model = pair
    p = prompts(3, 2, 8, tcfg.vocab_size)

    def sample(seed):
        eng = ServingEngine(tcfg, model, ServeConfig(
            max_len=40, temperature=0.8, seed=seed), device="cpu")
        return eng.generate(p, 16)

    first = sample(0)
    np.testing.assert_array_equal(first, sample(0))
    assert not np.array_equal(first, sample(1))
    assert ((0 <= first) & (first < tcfg.vocab_size)).all()


def test_generate_refuses_overlong_requests(pair):
    _, _, tcfg, model = pair
    eng = ServingEngine(tcfg, model, ServeConfig(max_len=10), device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        eng.generate(prompts(0, 1, 8, tcfg.vocab_size), 3)


def test_no_device_means_the_card(pair, monkeypatch):
    """Without a card, the default device raises instead of running on
    the CPU."""
    _, _, tcfg, model = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(tcfg, model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(tcfg, torch.Generator())


def test_engine_rejects_a_model_on_another_device(pair, monkeypatch):
    _, _, tcfg, model = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="model on cpu"):
        ServingEngine(tcfg, model, device="cuda")


def test_launch_serve_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--reduced", "--requests", "2", "--batch", "2", "--prompt-len", "8",
         "--new-tokens", "4"],
        env=env, capture_output=True, text=True, timeout=120, check=False)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0].startswith("[serve] round 0: generated (2, 4)")
    assert "codeqwen1.5-7b on cpu (float32, attention pallas)" in lines[-1]
    assert "16 tokens" in lines[-1]


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "zamba2-7b"])
def test_launch_serve_takes_the_ssm_and_hybrid_archs(arch, capsys):
    from repro_torch.launch.serve import main

    engine = main(["--arch", arch, "--device", "cpu", "--reduced",
                   "--requests", "1", "--batch", "2", "--prompt-len", "20",
                   "--new-tokens", "3"])
    assert engine.cfg.name == arch and engine.stats["tokens"] == 6
    assert f"{arch} on cpu (float32, attention pallas)" in \
        capsys.readouterr().out


def test_launch_serve_flags():
    from repro_torch.launch.serve import build_parser

    args = build_parser().parse_args([])
    assert (args.reduced, args.device, args.attention) == (
        False, "cuda", "pallas")
    cfg = dataclasses.replace(configs.get_config(args.arch),
                              attention_impl=args.attention)
    assert cfg.n_layers == 32 and cfg.dtype == "bfloat16"
    args = build_parser().parse_args(["--reduced", "--attention",
                                      "reference", "--device", "cpu"])
    assert (args.reduced, args.device, args.attention) == (
        True, "cpu", "reference")
