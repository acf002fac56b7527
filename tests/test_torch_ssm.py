"""The port's SSM mixers and ``loss_fn`` against the JAX package's.

``models/ssm.py``'s chunked gated linear attention, its one-token step
and the mLSTM, sLSTM and Mamba2 blocks run on the same seeded numpy
inputs and weights (the reference's ``*_init`` draws, carried across) in
both packages, in f32 on the CPU: within 1e-5, decode states included.
``loss_fn`` is held to the reference's for every family within 1e-5,
on reduced configs with the reference's weights (``params_from_jax``)
and the same ``make_batch`` draws."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import io as jax_io  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import (  # noqa: E402
    XLSTMLM, ZambaLM, init_params, layers, loss_fn, make_batch,
    params_from_jax, ssm,
)

TOL = dict(rtol=1e-5, atol=1e-5)
XLSTM, ZAMBA = "xlstm-1.3b", "zamba2-7b"
CHUNK = 16


def close(got: torch.Tensor, want, **tol) -> None:
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def cfg_pair(arch: str, **overrides):
    return (jax_configs.reduced(jax_configs.get_config(arch), **overrides),
            configs.reduced(configs.get_config(arch), **overrides))


def gla_inputs(rng, s: int, log_i_scale: float = 0.5, b=2, h=2, dk=8, dv=8):
    """q, k, v, log_f (decay: non-positive), log_i, as f32 numpy."""
    q, k = (rng.standard_normal((b, s, h, dk)) for _ in range(2))
    v = rng.standard_normal((b, s, h, dv))
    log_f = -np.abs(rng.standard_normal((b, s, h))) * 0.1
    log_i = rng.standard_normal((b, s, h)) * log_i_scale
    return [x.astype(np.float32) for x in (q, k, v, log_f, log_i)]


@pytest.mark.parametrize("log_i_scale", [0.5, 20.0],
                         ids=["log_i_small", "log_i_past_8"])
@pytest.mark.parametrize("with_state", [False, True],
                         ids=["zero_state", "given_state"])
@pytest.mark.parametrize("s", [64, 53], ids=["whole_chunks", "padded"])
def test_chunked_gla_matches_jax(s, with_state, log_i_scale):
    """Lengths a multiple of the chunk and not (the zero-padded tail), a
    given ``state0``, and ``log_i`` far past the ±8 clip.  Past the clip
    each input gate is up to exp(8) ≈ 2981, so the outputs reach 1e3-1e4
    and a sum's f32 error scales with them: there the absolute tolerance
    is 1e-5 of the largest output."""
    rng = np.random.default_rng(s + 10 * with_state)
    xs = gla_inputs(rng, s, log_i_scale)
    if log_i_scale > 8:
        assert (np.abs(xs[4]) > 8).any()
    st = (rng.standard_normal((2, 2, 8, 8)).astype(np.float32)
          if with_state else None)
    want, want_state = jax_ssm.chunked_gla(
        *map(jnp.asarray, xs), CHUNK,
        state0=None if st is None else jnp.asarray(st))
    got, got_state = ssm.chunked_gla(
        *map(torch.from_numpy, xs), CHUNK,
        state0=None if st is None else torch.from_numpy(st))
    assert got.shape == (2, s, 2, 8) and got_state.shape == (2, 2, 8, 8)
    for g, w in ((got, want), (got_state, want_state)):
        scale = float(np.abs(np.asarray(w)).max()) if log_i_scale > 8 else 1
        close(g, w, rtol=1e-5, atol=1e-5 * scale)


def test_chunked_gla_returns_v_dtype_like_jax():
    """bf16 v: the products run in f32 and the output comes back in bf16,
    as the reference's; the state stays f32 (one bf16 rounding apart)."""
    xs = gla_inputs(np.random.default_rng(3), 40)
    jx = [jnp.asarray(x) for x in xs]
    tx = [torch.from_numpy(x) for x in xs]
    jx[2], tx[2] = jx[2].astype(jnp.bfloat16), tx[2].to(torch.bfloat16)
    want, want_state = jax_ssm.chunked_gla(*jx, CHUNK)
    got, got_state = ssm.chunked_gla(*tx, CHUNK)
    assert got.dtype == torch.bfloat16 and got_state.dtype == torch.float32
    close(got, np.asarray(want, np.float32), rtol=1e-2, atol=1e-2)
    close(got_state, want_state)


def test_gla_decode_step_matches_jax():
    rng = np.random.default_rng(4)
    q, k, v, log_f, log_i = (x[:, 0] for x in gla_inputs(rng, 1, 20.0))
    st = rng.standard_normal((2, 2, 8, 8)).astype(np.float32)
    want_h, want_state = jax_ssm.gla_decode_step(
        *map(jnp.asarray, (st, q, k, v, log_f, log_i)))
    got_h, got_state = ssm.gla_decode_step(
        *map(torch.from_numpy, (st, q, k, v, log_f, log_i)))
    close(got_h, want_h)
    close(got_state, want_state)


def _block(cls, tree: dict):
    """A port block holding the reference's weights (a nested dict, the
    norm's, becomes a nested Params)."""
    def tensor(a):
        return torch.from_numpy(np.array(a))
    return cls(**{name: (layers.Params(**{n: tensor(a) for n, a in v.items()})
                         if isinstance(v, dict) else tensor(v))
                  for name, v in tree.items()})


#: block kind -> (arch, the port's block class)
KINDS = {"mlstm": (XLSTM, ssm.MLSTMBlock), "slstm": (XLSTM, ssm.SLSTMBlock),
         "mamba2": (ZAMBA, ssm.Mamba2Block)}


def block_pair(kind: str, seed: int):
    arch, cls = KINDS[kind]
    jcfg, tcfg = cfg_pair(arch)
    jp = getattr(jax_ssm, f"{kind}_init")(jax.random.key(seed), jcfg,
                                          jnp.float32)
    return jcfg, jp, tcfg, _block(cls, jp)


@pytest.mark.parametrize("kind", list(KINDS))
def test_block_apply_matches_jax(kind):
    """24 positions: one whole chunk of 16 and a padded one."""
    jcfg, jp, tcfg, tp = block_pair(kind, 5)
    x = (np.random.default_rng(6).standard_normal((2, 24, tcfg.d_model))
         * 0.5).astype(np.float32)
    want = getattr(jax_ssm, f"{kind}_apply")(jp, jcfg, jnp.asarray(x))
    got = getattr(ssm, f"{kind}_apply")(tp, tcfg, torch.from_numpy(x))
    close(got, want)


def _states(kind: str, cfg, rng):
    """Random (nonzero) decode states of a block, as numpy."""
    def draw(shape):
        return (rng.standard_normal(shape) * 0.5).astype(np.float32)
    if kind == "mlstm":
        return [draw(jax_ssm.mlstm_state_shape(cfg, 2))]
    if kind == "slstm":
        shape = jax_ssm.slstm_state_shape(cfg, 2)
        c, n, h = draw(shape), np.abs(draw(shape)) + 1, draw(shape)
        return [(c, n, h)]
    return [draw(s) for s in jax_ssm.mamba2_state_shapes(cfg, 2)]


@pytest.mark.parametrize("kind", list(KINDS))
def test_block_decode_matches_jax(kind):
    """Five one-token steps from random states: each step's output and
    every state within 1e-5."""
    jcfg, jp, tcfg, tp = block_pair(kind, 7)
    rng = np.random.default_rng(8)
    states = _states(kind, tcfg, rng)
    jst = jax.tree_util.tree_map(jnp.asarray, states)
    tst = jax.tree_util.tree_map(torch.from_numpy, states)
    jstep = getattr(jax_ssm, f"{kind}_decode")
    tstep = getattr(ssm, f"{kind}_decode")
    for _ in range(5):
        x = (rng.standard_normal((2, 1, tcfg.d_model)) * 0.5).astype(
            np.float32)
        want, *jst = jstep(jp, jcfg, jnp.asarray(x), *jst)
        got, *tst = tstep(tp, tcfg, torch.from_numpy(x), *tst)
        close(got, want)
        for g, w in zip(jax.tree_util.tree_leaves(tst),
                        jax.tree_util.tree_leaves(jst)):
            close(g, w)


def test_state_shapes_match_the_reference():
    for arch in (XLSTM, ZAMBA):
        jcfg, tcfg = cfg_pair(arch)
        for name in ("mlstm_state_shape", "slstm_state_shape",
                     "mamba2_state_shapes"):
            assert getattr(ssm, name)(tcfg, 3) == getattr(jax_ssm, name)(
                jcfg, 3)


#: one architecture of each family; zamba2 at 5 layers, so its tail holds
#: a block (the reduced default's 4 leave it empty)
LOSS_ARCHS = {"dense": ("codeqwen1.5-7b", {}),
              "moe": ("qwen3-moe-235b-a22b", {}),
              "vlm": ("llava-next-mistral-7b", {}),
              "audio": ("whisper-large-v3", {}),
              "ssm": (XLSTM, {}),
              "hybrid": (ZAMBA, {"n_layers": 5})}


@pytest.mark.parametrize("family", list(LOSS_ARCHS))
def test_loss_fn_matches_jax(family):
    """Next-token cross entropy and its perplexity within 1e-5 (vlm: the
    text positions only)."""
    arch, overrides = LOSS_ARCHS[family]
    jcfg, tcfg = cfg_pair(arch, **overrides)
    assert tcfg.family == family
    params = jax_tf.init_params(jcfg, jax.random.key(9))
    model = params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, params),
                            device="cpu")
    jb = jax_io.make_batch(jcfg, 2, 24, seed=10)
    tb = make_batch(tcfg, 2, 24, seed=10, device="cpu")
    want, want_m = jax_tf.loss_fn(jcfg, params, jb)
    got, got_m = loss_fn(tcfg, model, tb)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert sorted(got_m) == sorted(want_m) == ["loss", "perplexity"]
    close(got, want)
    for name in want_m:
        close(got_m[name], want_m[name])


@pytest.mark.parametrize("arch,cls,stacked",
                         [(XLSTM, XLSTMLM, "mblocks"),
                          (ZAMBA, ZambaLM, "mamba_sb")])
def test_params_from_jax_checks_the_stacking_against_cfg(arch, cls, stacked):
    """The superblock stacks must hold cfg's (superblocks, blocks a
    superblock); a tree from another depth is refused."""
    jcfg, tcfg = cfg_pair(arch)
    tree = jax.tree_util.tree_map(
        np.asarray, jax_tf.init_params(jcfg, jax.random.key(11)))
    assert isinstance(params_from_jax(tcfg, tree, device="cpu"), cls)
    tree[stacked] = jax.tree_util.tree_map(lambda a: a[:1], tree[stacked])
    with pytest.raises(ValueError, match="stacked"):
        params_from_jax(tcfg, tree, device="cpu")


@pytest.mark.parametrize("arch", [XLSTM, ZAMBA])
def test_init_params_draws_on_the_generator_device(arch):
    """Weights come from the generator given, on its device, in the
    reference's dtypes: the gates f32, the projections in cfg.dtype."""
    _, tcfg = cfg_pair(arch, dtype="bfloat16")
    a, b = (init_params(tcfg, torch.Generator().manual_seed(2), device="cpu")
            for _ in range(2))
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    blk = a.mblocks[0][0] if arch == XLSTM else a.mamba_sb[0][0]
    gate = blk["wf"] if arch == XLSTM else blk["wdt"]
    proj = blk["wq"] if arch == XLSTM else blk["w_in"]
    assert gate.dtype == torch.float32 and proj.dtype == torch.bfloat16


def test_ssm_sensitivity_tool_measures_both_packages(capsys):
    """``tools/ssm_sensitivity.py`` (the floor that ``chip_smoke.py``'s
    whole-model recurrent gate names): on a small cut, both packages'
    chunked and recurrent logits agree within 1e-4 and the one-roundoff
    floor is finite and small."""
    from tools import ssm_sensitivity

    out = ssm_sensitivity.main(["--d-model", "64", "--layers", "4",
                                "--prompt", "20", "--vocab", "256"])
    assert sorted(out) == ["jax", "port"]
    for dev in out.values():
        assert dev["recurrent_max"] < 1e-4
        assert 0 <= dev["floor_max"] < 1e-4
        assert dev["recurrent_mean"] <= dev["recurrent_max"]
    assert "chunked against recurrent" in capsys.readouterr().out
