"""The port's training substrate against the JAX package's: optimizer,
gradient compression, data pipeline, checkpoint/restart, the train loop
and the train step (``tests/test_training.py``'s cases, each numeric one
held to the reference on the same seeded numpy inputs).

Weights and optimizer states are carried across with ``params_from_jax``
and ``opt_from_jax``.  Tolerances: the optimizer's f32 arithmetic is the
reference's operation for operation, so parameters and moments agree
within 1e-6; the compression codes are equal; batches are equal; a whole
train step (a backward through the model, then AdamW) within 1e-5."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.data import DataConfig as JaxDataConfig  # noqa: E402
from repro.data import TokenPipeline as JaxTokenPipeline  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.training import compression as jax_comp  # noqa: E402
from repro.training import optimizer as jax_opt  # noqa: E402
from repro.training import train_step as jax_ts  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch.train import TrainLoop, run_with_restarts  # noqa: E402
from repro_torch.models import opt_from_jax, params_from_jax  # noqa: E402
from repro_torch.training import checkpoint  # noqa: E402
from repro_torch.training.checkpoint import (  # noqa: E402
    latest_step, list_steps, restore, save,
)
from repro_torch.training.compression import (  # noqa: E402
    compress, compress_tree, decompress, decompress_tree,
)
from repro_torch.training.optimizer import (  # noqa: E402
    OptConfig, adamw_init, adamw_update, global_norm, lr_at,
)
from repro_torch.training.train_step import make_steps  # noqa: E402

OPT_TOL = dict(rtol=1e-6, atol=1e-6)
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
#: with int8 gradient compression: the share of updated weights and moments
#: allowed outside STEP_TOL, where a code sits at a near tie (see
#: test_train_step_matches_jax)
NEAR_TIE_SHARE = 1e-3


def tiny_cfgs(**overrides):
    """``tests/test_training.py``'s tiny stablelm, in both packages."""
    small = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
                 head_dim=16, d_ff=64, vocab_size=128, **overrides)
    return (jax_configs.reduced(jax_configs.get_config("stablelm-1.6b"),
                                **small),
            configs.reduced(configs.get_config("stablelm-1.6b"), **small))


def tree_to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def named(cfg, tree) -> dict:
    """A reference params-shaped tree, by the port's parameter names."""
    return {n: t.detach().float().numpy() for n, t in
            params_from_jax(cfg, tree_to_numpy(tree),
                            device="cpu").named_parameters()}


def assert_named_close(got: dict, want: dict, **tol) -> None:
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.detach().float().numpy(), want[name],
                                   err_msg=name, **tol)


def random_grads(jcfg, params, seed: int):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape), p.dtype), params)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax_over_several_steps(dtype):
    """Two reference steps, then its state carried across
    (``opt_from_jax``) and three more in each package from equal states:
    params, m and v within 1e-6 (bf16 params: equal, both round the same
    f32 update once), the same learning rate and the grad norm within
    1e-5 (summed in another order)."""
    jcfg, tcfg = tiny_cfgs(dtype=dtype)
    # no clipping here (the norm is summed in another order, so a clipped
    # scale would differ by its rounding): test_grad_clip_bounds_update
    cfg = OptConfig(lr=1e-2, warmup_steps=3, total_steps=10,
                    clip_norm=1e4)
    jcfg_opt = jax_opt.OptConfig(lr=1e-2, warmup_steps=3, total_steps=10,
                                 clip_norm=1e4)
    params = jax_tf.init_params(jcfg, jax.random.key(0))
    opt = jax_opt.adamw_init(params)
    for s in range(2):
        params, opt, _ = jax_opt.adamw_update(
            jcfg_opt, params, random_grads(jcfg, params, s), opt)
    model = params_from_jax(tcfg, tree_to_numpy(params), device="cpu")
    mine = dict(model.named_parameters())
    topt = opt_from_jax(tcfg, tree_to_numpy(opt), device="cpu")
    assert int(topt["step"]) == 2 and sorted(topt["m"]) == sorted(mine)
    for s in range(2, 5):
        grads = random_grads(jcfg, params, s)
        params, opt, jm = jax_opt.adamw_update(jcfg_opt, params, grads, opt)
        tgrads = {n: torch.from_numpy(a).to(mine[n].dtype)
                  for n, a in named(tcfg, grads).items()}
        mine, topt, tm = adamw_update(cfg, mine, tgrads, topt)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    assert int(topt["step"]) == int(opt["step"]) == 5
    assert_named_close(mine, named(tcfg, params), **OPT_TOL)
    for moment in ("m", "v"):
        assert_named_close(topt[moment], named(tcfg, opt[moment]),
                           **OPT_TOL)
    assert all(t.dtype == torch.float32 for t in topt["m"].values())
    assert model.embed.dtype == getattr(torch, dtype)


def test_adamw_reduces_quadratic_loss():
    w = torch.tensor([5.0, -3.0], requires_grad=True)
    params = {"w": w}
    opt = adamw_init(params)
    cfg = OptConfig(lr=0.1, warmup_steps=0, total_steps=100,
                    weight_decay=0.0)
    for _ in range(200):
        grads = {"w": torch.autograd.grad((w ** 2).sum(), w)[0]}
        params, opt, _ = adamw_update(cfg, params, grads, opt)
    assert float(w.detach().abs().max()) < 0.1
    assert params["w"] is w                 # updated in place


def test_lr_schedule_warmup_and_decay():
    cfg = OptConfig(lr=1.0, warmup_steps=10, total_steps=100,
                    min_lr_frac=0.1)
    jcfg = jax_opt.OptConfig(lr=1.0, warmup_steps=10, total_steps=100,
                             min_lr_frac=0.1)
    assert float(lr_at(cfg, 5)) == pytest.approx(0.5)
    assert float(lr_at(cfg, torch.tensor(10))) == pytest.approx(1.0)
    assert float(lr_at(cfg, 100)) == pytest.approx(0.1)
    for step in (0, 1, 5, 9, 10, 11, 37, 99, 100, 150):
        assert float(lr_at(cfg, step)) == pytest.approx(
            float(jax_opt.lr_at(jcfg, jnp.asarray(step))), rel=1e-6)


def test_grad_clip_bounds_update():
    """The raw norm is reported; the update is the clipped one, as the
    reference's on the same inputs."""
    params = {"w": torch.zeros(4)}
    opt = adamw_init(params)
    cfg = OptConfig(lr=1e-3, clip_norm=1.0, warmup_steps=0,
                    weight_decay=0.0)
    jcfg = jax_opt.OptConfig(lr=1e-3, clip_norm=1.0, warmup_steps=0,
                             weight_decay=0.0)
    g = np.array([1e6, -2e6, 3e6, 0.5], np.float32)
    params, opt, metrics = adamw_update(cfg, params,
                                        {"w": torch.from_numpy(g)}, opt)
    assert float(metrics["grad_norm"]) > 1e5
    jp = {"w": jnp.zeros(4)}
    jp, jo, jm = jax_opt.adamw_update(jcfg, jp, {"w": jnp.asarray(g)},
                                      jax_opt.adamw_init(jp))
    np.testing.assert_allclose(params["w"].numpy(), np.asarray(jp["w"]),
                               **OPT_TOL)
    np.testing.assert_allclose(opt["m"]["w"].numpy(),
                               np.asarray(jo["m"]["w"]), **OPT_TOL)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)
    assert float(global_norm({"a": torch.full((4,), 3.0),
                              "b": torch.ones(2)})) == pytest.approx(
        float(jax_opt.global_norm({"a": jnp.full((4,), 3.0),
                                   "b": jnp.ones(2)})))


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(7,), (256,), (1000,), (3, 5, 17)])
def test_int8_compression_codes_equal_jax(shape):
    """Codes and scales equal to the reference's (round half to even);
    the round trip within a block's scale."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    # exact halves of a step, where rounding half to even decides
    x.reshape(-1)[:4] = np.array([0.5, 1.5, -2.5, 127.0], np.float32) \
        * np.abs(x).max() / 127.0
    got, want = compress(torch.from_numpy(x)), jax_comp.compress(
        jnp.asarray(x))
    np.testing.assert_array_equal(got["codes"].numpy(),
                                  np.asarray(want["codes"]))
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(want["scale"]))
    assert (got["shape"], got["pad"]) == (tuple(want["shape"]), want["pad"])
    y = decompress(got)
    assert tuple(y.shape) == shape and y.dtype == torch.float32
    np.testing.assert_array_equal(y.numpy(),
                                  np.asarray(jax_comp.decompress(want)))
    err = np.abs(x - y.numpy())
    assert err.max() <= np.abs(x).max() / 127.0 + 1e-7


def test_compression_zero_block():
    x = torch.zeros(512)
    c = compress(x)
    np.testing.assert_array_equal(
        c["codes"].numpy(),
        np.asarray(jax_comp.compress(jnp.zeros(512))["codes"]))
    np.testing.assert_array_equal(decompress(c).numpy(), 0.0)


def test_compress_tree_round_trips_nested_dicts():
    tree = {"a": torch.arange(300, dtype=torch.float32),
            "b": {"c": torch.full((2, 3), -1.0, dtype=torch.bfloat16)}}
    out = decompress_tree(compress_tree(tree))
    assert sorted(out) == ["a", "b"] and sorted(out["b"]) == ["c"]
    np.testing.assert_allclose(out["a"].numpy(), tree["a"].numpy(),
                               atol=300 / 254)
    np.testing.assert_array_equal(out["b"]["c"].numpy(), -1.0)


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_pipeline_batches_equal_jax(seed):
    cfg = DataConfig(batch=4, seq_len=16, vocab_size=100, seed=seed)
    jcfg = JaxDataConfig(batch=4, seq_len=16, vocab_size=100, seed=seed)
    mine, ref = TokenPipeline(cfg), JaxTokenPipeline(jcfg)
    for step in (0, 1, 5, 11):
        got, want = mine.batch_at(step), ref.batch_at(step)
        assert sorted(got) == sorted(want) == ["labels", "tokens"]
        for name in got:
            np.testing.assert_array_equal(got[name], want[name])
    assert not np.array_equal(mine.batch_at(0)["tokens"],
                              mine.batch_at(1)["tokens"])


def test_pipeline_reads_a_corpus_as_the_reference(tmp_path):
    path = tmp_path / "corpus.bin"
    np.arange(5000, dtype=np.uint32).tofile(path)
    cfg = DataConfig(batch=3, seq_len=8, vocab_size=4000, corpus=str(path))
    jcfg = JaxDataConfig(batch=3, seq_len=8, vocab_size=4000,
                         corpus=str(path))
    for step in (0, 2):
        np.testing.assert_array_equal(
            TokenPipeline(cfg).batch_at(step)["tokens"],
            JaxTokenPipeline(jcfg).batch_at(step)["tokens"])


def test_pipeline_host_slicing_partitions_batch():
    cfg = DataConfig(batch=8, seq_len=4, vocab_size=50, host_count=2)
    p0 = TokenPipeline(dataclasses.replace(cfg, host_index=0))
    p1 = TokenPipeline(dataclasses.replace(cfg, host_index=1))
    full = p0.batch_at(3)["tokens"]
    np.testing.assert_array_equal(p0.host_slice(p0.batch_at(3))["tokens"],
                                  full[:4])
    np.testing.assert_array_equal(p1.host_slice(p1.batch_at(3))["tokens"],
                                  full[4:])


def test_pipeline_background_prefetch():
    cfg = DataConfig(batch=2, seq_len=8, vocab_size=30, prefetch_depth=2)
    p = TokenPipeline(cfg).start(from_step=3)
    try:
        got = [p.next() for _ in range(4)]
        assert [s for s, _ in got] == [3, 4, 5, 6]
        np.testing.assert_array_equal(got[1][1]["tokens"],
                                      p.batch_at(4)["tokens"])
    finally:
        p.stop()
    assert not p._thread.is_alive()


# ---------------------------------------------------------------------------
# checkpoint + restart
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip_bf16(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3) / 3,
            "b": {"c": torch.ones(4) * 3, "step": torch.tensor(
                5, dtype=torch.int32)}}
    save(tmp_path, 7, tree)
    assert latest_step(tmp_path) == 7
    out = restore(tmp_path, 7, tree)
    assert out["a"].dtype == torch.bfloat16
    assert torch.equal(out["a"].view(torch.int16), tree["a"].view(
        torch.int16))
    assert torch.equal(out["b"]["c"], tree["b"]["c"])
    assert out["b"]["step"].dtype == torch.int32 and int(out["b"]["step"]) \
        == 5
    path = tmp_path / "step_000000007"
    manifest = __import__("json").loads((path / "manifest.json")
                                        .read_text())
    assert manifest["names"] == ["a", "b.c", "b.step"]
    assert manifest["dtypes"] == ["bfloat16", "float32", "int32"]
    # bf16 is stored as its raw 16-bit words
    with np.load(path / "arrays.npz") as data:
        assert data["a0"].dtype == np.uint16
    with pytest.raises(ValueError, match="tree mismatch"):
        restore(tmp_path, 7, {"x": tree["a"]})


def test_checkpoint_keep_n_and_commit_marker(tmp_path):
    tree = {"x": torch.zeros(3)}
    for s in (1, 2, 3, 4):
        save(tmp_path, s, tree, keep=2)
    assert latest_step(tmp_path) == 4
    assert list_steps(tmp_path) == [3, 4]
    # torn checkpoint (no commit marker) is ignored
    torn = tmp_path / "step_000000009"
    torn.mkdir()
    (torn / "manifest.json").write_text("{}")
    assert latest_step(tmp_path) == 4
    with pytest.raises(FileNotFoundError):
        restore(tmp_path, 9, tree)
    assert checkpoint.list_steps(tmp_path / "missing") == []


def tiny_loop_cfg():
    return tiny_cfgs()[1]


def test_train_loop_loss_decreases_and_resumes(tmp_path):
    cfg = tiny_loop_cfg()
    loop = TrainLoop(cfg, batch=4, seq=16, ckpt_dir=tmp_path, save_every=5,
                     device="cpu")
    # pin the batch (memorization): random streams have no learnable signal
    fixed = loop.pipeline.batch_at(0)
    loop.pipeline.batch_at = lambda step: fixed
    loop.init_or_restore()
    losses = loop.run(10, log_every=100)
    assert len(losses) == 10
    assert losses[-1] < losses[0]  # memorizes the fixed batch
    # new loop resumes from step 10, with the saved weights and moments
    loop2 = TrainLoop(cfg, batch=4, seq=16, ckpt_dir=tmp_path, save_every=5,
                      device="cpu")
    start = loop2.init_or_restore()
    assert start == 10
    (m1, o1), (m2, o2) = loop.state, loop2.state
    for (n, a), b in zip(m1.state_dict().items(), m2.state_dict().values()):
        assert torch.equal(a, b), n
    assert int(o2["step"]) == 10
    assert all(torch.equal(o1["v"][n], o2["v"][n]) for n in o1["v"])
    assert all(p.requires_grad for p in m2.parameters())


def test_crash_restart_supervisor(tmp_path):
    cfg = tiny_loop_cfg()

    def make_loop():
        return TrainLoop(cfg, batch=4, seq=16, ckpt_dir=tmp_path,
                         save_every=4, device="cpu")

    losses, restarts = run_with_restarts(
        make_loop, 12, inject_failure_at=6)
    assert restarts == 1
    # crashed at step 6 after the step-4 checkpoint; the retry resumes at 4
    # and runs 4..11 -> 8 recorded steps (the failed attempt's are discarded)
    assert len(losses) == 8


def test_train_cli_on_the_cpu(tmp_path, capsys):
    train_mod.main(["--reduced", "--device", "cpu", "--steps", "3",
                    "--batch", "2", "--seq", "16", "--attention", "blocked",
                    "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[train] done: 3 steps, restarts=0" in out
    assert latest_step(tmp_path) == 3


# ---------------------------------------------------------------------------
# the train step against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("microbatches,compress_grads",
                         [(1, False), (2, False), (1, True), (2, True)])
def test_train_step_matches_jax(microbatches, compress_grads):
    """One step of each package's ``make_steps`` train step from equal
    params and optimizer state (two reference steps in, carried across):
    loss, grad norm, updated params and moments within 1e-5.  With
    compression an int8 code may differ by one step where a gradient lies
    within its f32 rounding of a half-step (the two backwards sum in other
    orders), and AdamW normalises that step into a visible update: such
    elements are counted and held to ``NEAR_TIE_SHARE`` of the weights
    and moments (1 of 57,984 on this seed with one microbatch, none with
    two); the codes themselves are held equal by
    ``test_compression_blocks_as_the_reference_stacks``."""
    jcfg, tcfg = tiny_cfgs()
    kw = dict(microbatches=microbatches, compress_grads=compress_grads)
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=20)
    jsteps = jax_ts.make_steps(jcfg, jax_opt.OptConfig(**ocfg), **kw)
    tsteps = make_steps(tcfg, OptConfig(**ocfg), **kw)
    params = jax_tf.init_params(jcfg, jax.random.key(4))
    opt = jsteps["init_opt"](params)
    rng = np.random.default_rng(8)
    tokens = [rng.integers(0, jcfg.vocab_size, (4, 16)).astype(np.int32)
              for _ in range(3)]
    for t in tokens[:2]:
        params, opt, _ = jsteps["train_step"](params, opt,
                                              {"tokens": jnp.asarray(t)})
    model = params_from_jax(tcfg, tree_to_numpy(params), device="cpu")
    topt = opt_from_jax(tcfg, tree_to_numpy(opt), device="cpu")
    params, opt, want = jsteps["train_step"](
        params, opt, {"tokens": jnp.asarray(tokens[2])})
    model, topt, got = tsteps["train_step"](
        model, topt, {"tokens": torch.from_numpy(tokens[2])})
    for key in ("loss", "perplexity", "grad_norm", "lr"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-5, err_msg=key)
    mine = dict(model.named_parameters())
    if not compress_grads:
        assert_named_close(mine, named(tcfg, params), **STEP_TOL)
        assert_named_close(topt["m"], named(tcfg, opt["m"]), **STEP_TOL)
        return
    total = off = 0
    for got_t, want_t in ((mine, named(tcfg, params)),
                          (topt["m"], named(tcfg, opt["m"]))):
        for name, g in got_t.items():
            g = g.detach().numpy()
            w = want_t[name]
            off += int((np.abs(g - w) > 1e-5 + 1e-5 * np.abs(w)).sum())
            total += g.size
    assert off <= NEAR_TIE_SHARE * total, (off, total)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_compression_blocks_as_the_reference_stacks(arch):
    """The reference compresses its layer-stacked leaves, so at the tiny
    widths a 256-element block straddles layers: the train step's round
    trip gives the reference's values exactly on the same gradients, for
    every family's stacks (zamba2's two stack axes, the moe experts,
    whisper's encoder and decoder)."""
    from repro_torch.training.train_step import _compress_round_trip

    if arch == "stablelm-1.6b":
        jcfg, tcfg = tiny_cfgs()
    else:
        jcfg, tcfg = (jax_configs.reduced(jax_configs.get_config(arch)),
                      configs.reduced(configs.get_config(arch)))
    params = jax_tf.init_params(jcfg, jax.random.key(6))
    grads = random_grads(jcfg, params, 7)
    want = named(tcfg, jax_comp.decompress_tree(
        jax_comp.compress_tree(grads)))
    got = _compress_round_trip({n: torch.from_numpy(a) for n, a in
                                named(tcfg, grads).items()})
    assert list(got) == list(want)
    for name, g in got.items():
        np.testing.assert_array_equal(g.numpy(), want[name], err_msg=name)


def test_prefill_and_decode_steps_match_jax():
    jcfg, tcfg = tiny_cfgs()
    params = jax_tf.init_params(jcfg, jax.random.key(5))
    model = params_from_jax(tcfg, tree_to_numpy(params), device="cpu")
    model.requires_grad_(True)          # a trained model serves as well
    jsteps, tsteps = jax_ts.make_steps(jcfg), make_steps(tcfg)
    tokens = np.random.default_rng(9).integers(
        0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    want = jsteps["prefill_step"](params, {"tokens": jnp.asarray(tokens)})
    got = tsteps["prefill_step"](model, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (2, 1, jcfg.vocab_size) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEP_TOL)
    opt = tsteps["init_opt"](model)
    assert sorted(opt["m"]) == sorted(n for n, _ in model.named_parameters())
