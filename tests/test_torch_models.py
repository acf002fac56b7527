"""The port's LM layers and dense transformer against the JAX package's.

Weights and inputs are made with seeded numpy (or by the JAX package's
own ``init_params`` and carried across with ``params_from_jax``); both
packages run in f32 on the CPU and must agree within 1e-4 (they sum in
different orders).  The JAX flash kernel runs in interpret mode, the
port's on its plain version."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import io as jax_io  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import attention, io, layers, transformer  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


def both(a: np.ndarray):
    return jnp.asarray(a), torch.from_numpy(a)


def close(got: torch.Tensor, want, **tol) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def tree_to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def cfg_pair(arch: str, **overrides):
    return (jax_configs.reduced(jax_configs.get_config(arch), **overrides),
            configs.reduced(configs.get_config(arch), **overrides))


def test_configs_are_the_references():
    assert configs.ARCH_IDS == jax_configs.ARCH_IDS
    for name in configs.ARCH_IDS:
        mine = dataclasses.asdict(configs.get_config(name))
        assert mine == dataclasses.asdict(jax_configs.get_config(name))
        assert dataclasses.asdict(configs.reduced(configs.get_config(name))) \
            == dataclasses.asdict(jax_configs.reduced(
                jax_configs.get_config(name)))
    full = configs.get_config("codeqwen1.5-7b")
    assert full.param_count() == jax_configs.get_config(
        "codeqwen1.5-7b").param_count()


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_apply(kind, dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3 + 1
    p = {"scale": rng.standard_normal(64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    jp = {k: jnp.asarray(a) for k, a in p.items()}
    tp = {k: torch.from_numpy(a) for k, a in p.items()}
    jx, tx = both(x)
    got = layers.norm_apply(tp, tx.to(getattr(torch, dtype)), kind)
    want = jax_layers.norm_apply(jp, jx.astype(getattr(jnp, dtype)), kind)
    assert got.dtype == getattr(torch, dtype)
    # bf16: the one rounding of the output may differ by an ulp
    tol = TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    close(got.float(), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 4000, size=(2, 9)).astype(np.int32)
    jx, tx = both(x)
    got = layers.rope(tx, torch.from_numpy(pos), theta)
    close(got, jax_layers.rope(jx, jnp.asarray(pos), theta), rtol=1e-4,
          atol=5e-4)


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_mlp(kind):
    rng = np.random.default_rng(2)
    p = {n: rng.standard_normal(s).astype(np.float32) * 0.2
         for n, s in (("w1", (32, 48)), ("w3", (32, 48)), ("w2", (48, 32)))}
    x = rng.standard_normal((2, 7, 32)).astype(np.float32)
    mine, ref_fn = {"swiglu": (layers.swiglu_mlp, jax_layers.swiglu_mlp),
                    "gelu": (layers.gelu_mlp, jax_layers.gelu_mlp)}[kind]
    got = mine({k: torch.from_numpy(a) for k, a in p.items()},
               torch.from_numpy(x))
    want = ref_fn({k: jnp.asarray(a) for k, a in p.items()}, jnp.asarray(x))
    close(got, want)
    gen = torch.Generator().manual_seed(0)
    names = {"swiglu": ["w1", "w2", "w3"], "gelu": ["w1", "w2"]}[kind]
    made = layers.mlp_init(gen, 32, 48, torch.bfloat16, kind=kind)
    assert sorted(n for n, _ in made.named_parameters()) == names
    assert made["w2"].shape == (48, 32) and made["w2"].dtype == torch.bfloat16


def test_initializers_match_the_references_distribution():
    """Different streams, the same law: truncated at ±2 / sqrt(fan_in),
    std 0.02 embeddings."""
    gen = torch.Generator().manual_seed(0)
    w = layers.dense_init(gen, (256, 512))
    assert w.abs().max() <= 2 / 16 + 1e-6
    assert abs(float(w.std()) - float(np.std(np.asarray(
        jax_layers.dense_init(jax.random.key(0), (256, 512)))))) < 2e-3
    e = layers.embed_init(gen, (512, 64))
    assert abs(float(e.std()) - 0.02) < 1e-3


def _attn_weights(rng, cfg):
    d, hd = cfg.d_model, cfg.head_dim
    shapes = {"wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
              "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d)}
    return {n: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
            for n, s in shapes.items()}


@pytest.mark.parametrize("impl", ["pallas", "reference"])
@pytest.mark.parametrize("arch,n_kv", [("codeqwen1.5-7b", 4),
                                       ("yi-34b", 1)])
def test_attention_block(impl, arch, n_kv):
    jcfg, tcfg = cfg_pair(arch, n_kv_heads=n_kv, attention_impl=impl)
    rng = np.random.default_rng(3)
    w = _attn_weights(rng, tcfg)
    x = rng.standard_normal((2, 40, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40)).copy()
    got, (gk, gv) = attention.attention(
        {k: torch.from_numpy(a) for k, a in w.items()}, tcfg,
        torch.from_numpy(x), torch.from_numpy(pos))
    want, (wk, wv) = jax_attn.attention(
        {k: jnp.asarray(a) for k, a in w.items()}, jcfg, jnp.asarray(x),
        jnp.asarray(pos))
    close(got, want)
    close(gk, wk)
    close(gv, wv)


def test_blocked_attention_route_matches_jax():
    """``attention_impl="blocked"`` runs the port's blocked loop (the
    reference's ``custom_vjp`` training attention): the attention block
    against the reference's blocked route, and the whole model's logits
    against the reference's (as its
    ``test_model_forward_blocked_equals_reference``)."""
    jcfg, tcfg = cfg_pair("codeqwen1.5-7b", attention_impl="blocked")
    rng = np.random.default_rng(0)
    w = _attn_weights(rng, tcfg)
    x = rng.standard_normal((2, 40, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40)).copy()
    got, _ = attention.attention(
        {k: torch.from_numpy(a) for k, a in w.items()}, tcfg,
        torch.from_numpy(x), torch.from_numpy(pos))
    want, _ = jax_attn.attention(
        {k: jnp.asarray(a) for k, a in w.items()}, jcfg, jnp.asarray(x),
        jnp.asarray(pos))
    close(got, want)
    params = jax_tf.init_params(jcfg, jax.random.key(0))
    model = params_from_jax(tcfg, tree_to_numpy(params), device="cpu")
    tokens = rng.integers(0, tcfg.vocab_size, (2, 32)).astype(np.int32)
    want = jax_tf.forward(jcfg, params, {"tokens": jnp.asarray(tokens)})
    got = transformer.forward(tcfg, model,
                              {"tokens": torch.from_numpy(tokens)})
    close(got, want)


def test_pallas_route_raises_under_autograd():
    """The flash kernels have no backward (``jax.grad`` through the
    reference's fails too): where autograd would record the call, the
    ``"pallas"`` route raises on the CPU as on a card, rather than run the
    differentiable plain version; without grad it computes."""
    _, tcfg = cfg_pair("codeqwen1.5-7b", attention_impl="pallas")
    w = {k: torch.from_numpy(a).requires_grad_()
         for k, a in _attn_weights(np.random.default_rng(1), tcfg).items()}
    x = torch.zeros((1, 4, tcfg.d_model))
    pos = torch.arange(4, dtype=torch.int32)[None]
    with pytest.raises(NotImplementedError, match="no backward"):
        attention.attention(w, tcfg, x, pos)
    with torch.no_grad():
        out, _ = attention.attention(w, tcfg, x, pos)
    assert out.shape == (1, 4, tcfg.d_model)


@pytest.mark.parametrize("pos", [0, 5, 15])
def test_decode_attention(pos):
    jcfg, tcfg = cfg_pair("codeqwen1.5-7b", n_kv_heads=2)
    rng = np.random.default_rng(4)
    w = _attn_weights(rng, tcfg)
    x = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
    shape = (2, 16, tcfg.n_kv_heads, tcfg.head_dim)
    kc = rng.standard_normal(shape).astype(np.float32)
    vc = rng.standard_normal(shape).astype(np.float32)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got, gk, gv = attention.decode_attention(
        {k: torch.from_numpy(a) for k, a in w.items()}, tcfg,
        torch.from_numpy(x), tk, tv, pos)
    want, wk, wv = jax_attn.decode_attention(
        {k: jnp.asarray(a) for k, a in w.items()}, jcfg, jnp.asarray(x),
        jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(pos, jnp.int32))
    close(got, want)
    close(gk, wk)
    close(gv, wv)
    assert gk is tk and gv is tv          # updated in place


@pytest.mark.parametrize("arch,impl", [
    ("codeqwen1.5-7b", "pallas"), ("codeqwen1.5-7b", "reference"),
    ("stablelm-1.6b", "pallas"), ("yi-34b", "reference"),
])
def test_forward_logits_from_jax_params(arch, impl):
    jcfg, tcfg = cfg_pair(arch, attention_impl=impl)
    params = jax_tf.init_params(jcfg, jax.random.key(7))
    model = params_from_jax(tcfg, tree_to_numpy(params), device="cpu")
    tokens = np.random.default_rng(5).integers(
        0, tcfg.vocab_size, (2, 24)).astype(np.int32)
    want = jax_tf.forward(jcfg, params, {"tokens": jnp.asarray(tokens)})
    got = transformer.forward(tcfg, model,
                              {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (2, 24, tcfg.vocab_size)
    close(got, want)
    last = transformer.forward(tcfg, model,
                               {"tokens": torch.from_numpy(tokens)},
                               last_only=True)
    close(last, np.asarray(want)[:, -1:])


def test_params_from_jax_keeps_layout_and_dtype():
    jcfg, tcfg = cfg_pair("codeqwen1.5-7b", dtype="bfloat16")
    params = jax_tf.init_params(jcfg, jax.random.key(1))
    model = params_from_jax(tcfg, tree_to_numpy(params), device="cpu")
    wq = np.asarray(params["layers"]["attn"]["wq"][1], np.float32)
    got = model.layers[1].attn["wq"]
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == wq.shape
    np.testing.assert_array_equal(got.float().numpy(), wq)
    assert model.layers[0].ln1["scale"].dtype == torch.float32
    assert model.lm_head.shape == (tcfg.d_model, tcfg.vocab_size)


def test_init_params_shapes_and_seeding():
    _, tcfg = cfg_pair("stablelm-1.6b")
    a = transformer.init_params(tcfg, torch.Generator().manual_seed(3),
                                device="cpu")
    b = transformer.init_params(tcfg, torch.Generator().manual_seed(3),
                                device="cpu")
    jshapes = jax_tf.param_shapes(cfg_pair("stablelm-1.6b")[0])
    assert tuple(a.embed.shape) == jshapes["embed"].shape
    assert tuple(a.layers[0].mlp["w2"].shape) == \
        jshapes["layers"]["mlp"]["w2"].shape[1:]
    assert a.layers[0].ln1["bias"].shape == (tcfg.d_model,)
    assert len(a.layers) == tcfg.n_layers
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "llava-next-mistral-7b",
                                  "whisper-large-v3"])
def test_make_batch_draws_the_references_tokens(arch):
    jcfg = jax_configs.reduced(jax_configs.get_config(arch))
    tcfg = configs.reduced(configs.get_config(arch))
    want = jax_io.make_batch(jcfg, 2, 20, seed=3)
    got = io.make_batch(tcfg, 2, 20, seed=3, device="cpu")
    assert io.text_len(tcfg, 20) == jax_io.text_len(jcfg, 20)
    assert set(got) == set(want)
    for name, arr in want.items():
        np.testing.assert_allclose(got[name].float().numpy(),
                                   np.asarray(arr, np.float32), rtol=0,
                                   atol=0)
