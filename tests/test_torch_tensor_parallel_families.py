"""Tensor parallelism on the ``model`` axis for the audio, ssm and hybrid
families: whisper's encoder, decoder and cross attention, and the mLSTM,
sLSTM and Mamba2 mixers (``repro_torch.models.ssm``).

One module fixture starts a 4-rank gloo world (each rank a process with
a ``FileStore`` in ``tmp_path``; no port is opened) beside the
reference's jitted loss and gradients of the same cases on 4 fake XLA
devices and its greedy serving, in a subprocess a case.  The cases are reduced
whisper-large-v3 (encoder_seq 16), xlstm-1.3b (4 heads), xlstm-1.3b at 2
heads (at |model| 4 a head spans two ranks: the mixers gather q, k and
v) and zamba2-7b at 5 layers (a Mamba2 tail), in f32, each at (1, 4) and
(2, 2) with ``act_shard`` "none" and "seq_model".  Each rank writes its
results to a JSON file (rank 0 the tensors to ``.npz`` files).

Tolerances: the loss within 1e-5 relative and every gradient within 1e-4
of its tensor's max-abs of the unsharded port's, on every rank, and
within 1e-3 of the reference's jitted ones on the same mesh shape;
greedy tokens equal to the reference's and every step's logits within
1e-4; the caches placed by ``rules.cache_pspec``.

The threaded tests below run the ranks of one axis as threads over a
stub of the collectives (no processes): the two helpers of ``sharding.tp``
against the whole computation, and each mixer against its whole-weight
self at |model| 1, 2 and 4, gradients included, within 1e-6 of the
whole's max-abs (f32: a few ulps, as the pieces sum in other orders).
"""

import functools
import json
import os
import pickle
import subprocess
import sys
import textwrap
import threading
import types
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.sharding import tp  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SRC = str(REPO / "src")
#: the cases: (arch, overrides of ``reduced``)
SPECS = {
    "audio": ("whisper-large-v3", {}),
    "ssm": ("xlstm-1.3b", {}),
    "ssm2": ("xlstm-1.3b", dict(n_heads=2, n_kv_heads=2)),
    "hybrid": ("zamba2-7b", dict(n_layers=5)),
}
MESHES = ("1x4", "2x2")
ACTS = ("none", "seq_model")
CASES = [f"{name} {mesh} {act}" for name in SPECS for mesh in MESHES
         for act in ACTS]
#: the loss's batch: 4 rows of 24 tokens (a whole chunk of 16 and a
#: padded one); the greedy run's: 2 prompts of 20 into a 24-position
#: cache, ``TP_NEW`` decode steps
LOSS_ROWS, LOSS_SEQ = 4, 24
SERVE_ROWS, SERVE_SEQ, MAX_LEN = 2, 20, 24
TP_NEW = 4
#: the families whose step at (1, 4) gathers no model shard whole (ssm2
#: gathers q, k and v activations, not weights)
WHOLE_CHECKS = ("audio", "ssm", "hybrid")

_WORKER = textwrap.dedent(r'''
import json, pickle, sys
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.launch import roofline
from repro_torch.launch.mesh import init_from_store, make_local_mesh
from repro_torch.models import params_from_jax, transformer
from repro_torch.models.transformer import decode_step, param_shapes, prefill
from repro_torch.sharding import place, rules, tp
from repro_torch.training.train_step import batch_rows, mesh_loss

rank, size, tmp = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])
data = pickle.loads((tmp / "inputs.pkl").read_bytes())
init_from_store(dist.FileStore(str(tmp / "store"), size), rank, size,
                device="cpu")
out = {"backend": dist.get_backend()}


def cfg_of(spec, **over):
    return configs.reduced(configs.get_config(spec["arch"]), **spec["over"],
                           **over)


def tensors(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def placed(cfg, spec, mesh, training=True):
    model = params_from_jax(cfg, spec["params"], device="cpu")
    return place.distribute_model(model, rules.param_specs(
        cfg, param_shapes(cfg), mesh, training=training), mesh)


def grads_of(cfg, model, batch, mesh):
    """(the global loss, every gradient as a global tensor)."""
    model.requires_grad_(True)
    names = [n for n, _ in model.named_parameters()]
    axes = () if mesh is None else batch_rows(mesh, batch)[0]
    with place.batch_axes(axes):
        loss, share = mesh_loss(cfg, model, batch, mesh, with_local=True)
        grads = torch.autograd.grad(share, list(model.parameters()))
    return float(loss), {n: g.full_tensor() if place.is_dtensor(g) else g
                         for n, g in zip(names, grads)}


def greedy(cfg, model, batch, n, length):
    with torch.no_grad():
        logits, cache = prefill(cfg, model, batch, length)
        where = {k: str(v.placements) for k, v in cache.items()
                 if place.is_dtensor(v)}
        toks, outs = [], [logits]
        for _ in range(n):
            tok = torch.argmax(logits[:, -1, :], dim=-1, keepdim=True)
            toks.append(tok)
            logits, cache = decode_step(cfg, model, cache, tok)
            outs.append(logits)
    return torch.cat(toks, dim=1).numpy(), torch.stack(outs).numpy(), where


def cases():
    res = {}
    for name, spec in data["specs"].items():
        cfg = cfg_of(spec)
        batch = tensors(spec["loss_batch"])
        plain_loss, plain = grads_of(
            cfg, params_from_jax(cfg, spec["params"], device="cpu"), batch,
            None)
        for shape in ((1, 4), (2, 2)):
            mesh = make_local_mesh(*shape, device="cpu")
            for act in ("none", "seq_model"):
                key = f"{name} {shape[0]}x{shape[1]} {act}"
                c = cfg_of(spec, act_shard=act)
                model = placed(c, spec, mesh)
                axis = tp.axis_of(c, model.parameters())
                loss, grads = grads_of(c, model, batch, mesh)
                worst = max(float((grads[n] - g).abs().max()
                                  / g.abs().max().clamp_min(1e-30))
                            for n, g in plain.items())
                r = {"loss": loss, "plain_loss": plain_loss,
                     "grad_vs_plain": worst, "file": f"tp_{len(res)}",
                     "axis": None if axis is None else list(axis[:2])}
                s = cfg_of(spec, act_shard=act, attention_impl="pallas")
                toks, logits, r["cache"] = greedy(
                    s, placed(s, spec, mesh, training=False),
                    tensors(spec["serve_batch"]), data["tp_new"],
                    data["max_len"])
                if rank == 0:
                    np.savez(tmp / f"{r['file']}_serve.npz", tokens=toks,
                             logits=logits)
                    np.savez(tmp / f"{r['file']}.npz",
                             **{n: g.numpy() for n, g in grads.items()})
                res[key] = r
    return res


def whole_gathers(name):
    """At (1, 4): the bytes of the weights the model axis shards that this
    rank holds after its gathers (each weight once), how many gathers
    returned one whole, and the step's collective bytes, on the
    tensor-parallel path and on the whole-weight path."""
    spec = data["specs"][name]
    cfg, mesh = cfg_of(spec), make_local_mesh(1, 4, device="cpu")
    batch = tensors(spec["loss_batch"])
    res = {}
    for path in ("tp", "whole"):
        held, whole = {}, [0, 0]
        gather = place.local

        def recording(t, *args, **kw):
            got = gather(t, *args, **kw)
            if tp.model_dim(t) is not None:
                held[id(t)] = got.numel() * got.element_size()
                whole[0] += got.numel() == t.numel()
                whole[1] += 1
            return got

        mode = roofline._comm_mode()
        with mock.patch.object(place, "local", recording), \
                mock.patch.object(transformer, "local", recording), \
                mock.patch.object(tp, "axis_of", (lambda *a: None)
                                  if path == "whole" else tp.axis_of):
            with mode:
                grads_of(cfg, placed(cfg, spec, mesh), batch, mesh)
        res[path] = {"held_bytes": sum(held.values()),
                     "gathered_whole": whole[0], "gathers": whole[1],
                     "bytes": dict(mode.bytes)}
    return res


out["cases"] = cases()
out["whole"] = {name: whole_gathers(name) for name in data["whole_checks"]}
dist.barrier()
(tmp / f"w_{rank}.json").write_text(json.dumps(out))
dist.destroy_process_group()
''')

_JAX = textwrap.dedent(r'''
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import pickle, sys
from pathlib import Path
import jax, jax.numpy as jnp, numpy as np
from repro import configs
from repro.launch.mesh import make_local_mesh
from repro.models import decode_step, loss_fn, moe, param_shapes, prefill
from repro.sharding import rules

tmp, name = Path(sys.argv[1]), sys.argv[2]
data = pickle.loads((tmp / "inputs.pkl").read_bytes())


def greedy(cfg, params, batch, n, length):
    logits, cache = prefill(cfg, params, batch, length)
    step = jax.jit(lambda c, t: decode_step(cfg, params, c, t))
    toks, outs = [], [np.asarray(logits)]
    for _ in range(n):
        tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(tok))
        logits, cache = step(cache, tok)
        outs.append(np.asarray(logits))
    return np.concatenate(toks, axis=1), np.stack(outs)


out = {}
spec = data["specs"][name]
params = jax.tree_util.tree_map(jnp.asarray, spec["params"])
batch = {k: jnp.asarray(v) for k, v in spec["loss_batch"].items()}
for d, m in ((1, 4), (2, 2)):
    mesh = make_local_mesh(d, m)
    moe.set_mesh(mesh)
    for act in ("none", "seq_model"):
        cfg = configs.reduced(configs.get_config(spec["arch"]),
                              **spec["over"], act_shard=act)
        shard = rules.named(mesh, rules.param_specs(
            cfg, param_shapes(cfg), mesh))
        with mesh:
            loss, grads = jax.jit(
                jax.value_and_grad(lambda p, b: loss_fn(cfg, p, b)[0]),
                in_shardings=(shard, None))(params, batch)
        out[f"{name} {d}x{m} {act}"] = (
            float(loss), jax.tree_util.tree_map(np.asarray, grads))
    moe.set_mesh(None)
cfg = configs.reduced(configs.get_config(spec["arch"]), **spec["over"])
sb = {k: jnp.asarray(v) for k, v in spec["serve_batch"].items()}
out[name] = greedy(cfg, params, sb, data["tp_new"], data["max_len"])
(tmp / f"jax_{name}.pkl").write_bytes(pickle.dumps(out))
''')


def _batch(cfg, rng, rows: int, seq: int) -> dict:
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (rows, seq)).astype(np.int32)}
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (rows, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def _inputs() -> dict:
    """Each case's reference weights and batches."""
    rng = np.random.default_rng(5)
    specs = {}
    for i, (name, (arch, over)) in enumerate(SPECS.items()):
        cfg = jax_configs.reduced(jax_configs.get_config(arch), **over)
        params = jax.jit(functools.partial(jax_init_params, cfg))(
            jax.random.key(20 + i))
        specs[name] = {
            "arch": arch, "over": over,
            "params": jax.tree_util.tree_map(np.asarray, params),
            "loss_batch": _batch(cfg, rng, LOSS_ROWS, LOSS_SEQ),
            "serve_batch": _batch(cfg, rng, SERVE_ROWS, SERVE_SEQ)}
    return {"specs": specs, "tp_new": TP_NEW, "max_len": MAX_LEN,
            "whole_checks": list(WHOLE_CHECKS)}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The reference's runs (a process a case) and the 4-rank world, at
    once."""
    tmp = tmp_path_factory.mktemp("tp_families")
    (tmp / "inputs.pkl").write_bytes(pickle.dumps(_inputs()))
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, "-c", _JAX, str(tmp), name],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for name in SPECS]
    for rank in range(4):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(rank), "4", str(tmp)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    errors = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
        if p.returncode != 0:
            errors.append(err[-3000:])
    assert not errors, errors[0]
    want = {}
    for name in SPECS:
        want.update(pickle.loads((tmp / f"jax_{name}.pkl").read_bytes()))
    return {"ranks": [json.loads((tmp / f"w_{r}.json").read_text())
                      for r in range(4)],
            "jax": want, "tmp": tmp}


def _port_named(name: str, tree) -> dict:
    """A reference params-shaped tree of a case, by the port's names."""
    from repro_torch.models import params_from_jax

    arch, over = SPECS[name]
    cfg = configs.reduced(configs.get_config(arch), **over)
    return {n: t.detach().numpy() for n, t in
            params_from_jax(cfg, tree, device="cpu").named_parameters()}


@pytest.mark.parametrize("case", CASES)
def test_family_axis_is_the_model_axis(results, case):
    """``tp.axis_of`` answers the ``model`` axis (its size and this
    rank's index) for the model placed by the reference's specs, on
    gloo."""
    m = int(case.split()[1].split("x")[1])
    for rank, r in enumerate(results["ranks"]):
        assert r["backend"] == "gloo"
        assert r["cases"][case]["axis"] == [m, rank % m]


@pytest.mark.parametrize("case", CASES)
def test_family_step_matches_the_unsharded_port(results, case):
    """The loss within 1e-5 relative and every gradient within 1e-4 of its
    tensor's max-abs of the same weights unplaced, on every rank."""
    for r in results["ranks"]:
        got = r["cases"][case]
        assert abs(got["loss"] - got["plain_loss"]) <= 1e-5 * abs(
            got["plain_loss"]), got
        assert got["grad_vs_plain"] <= 1e-4, got


@pytest.mark.parametrize("case", CASES)
def test_family_step_matches_the_reference_on_the_same_mesh(results, case):
    """The reference's jitted loss and gradients with its weights placed
    by its specs on the same mesh shape: within 1e-3 (every gradient of
    its tensor's max-abs)."""
    loss, grads = results["jax"][case]
    want = _port_named(case.split()[0], grads)
    r = results["ranks"][0]["cases"][case]
    assert abs(r["loss"] - loss) < 1e-3 * max(1.0, abs(loss))
    got = np.load(results["tmp"] / f"{r['file']}.npz")
    assert sorted(got.files) == sorted(want)
    for name, w in want.items():
        assert np.abs(got[name] - w).max() <= 1e-3 * np.abs(w).max(), name


@pytest.mark.parametrize("case", CASES)
def test_family_serving_matches_the_reference(results, case):
    """``prefill`` and ``TP_NEW`` greedy ``decode_step``s on the model
    placed by the inference specs: tokens equal to the reference's loop
    and every step's logits within 1e-4."""
    toks, logits = results["jax"][case.split()[0]]
    r = results["ranks"][0]["cases"][case]
    got = np.load(results["tmp"] / f"{r['file']}_serve.npz")
    np.testing.assert_array_equal(got["tokens"], toks)
    np.testing.assert_allclose(got["logits"], logits, rtol=0, atol=1e-4)


def _want_placements(name: str, m: int) -> dict:
    """``cache_pspec``'s ``model`` entries for a case's cache, as DTensor
    placements on the (data, model) mesh: the SSM states by heads, the
    conv windows by channels, the KV caches (the shared block's, and the
    decoder's self and cross ones) by heads, the sLSTM carry whole."""
    arch, over = SPECS[name]
    cfg = configs.reduced(configs.get_config(arch), **over)
    heads = cfg.n_heads % m == 0

    def on(dim):
        return f"(Replicate(), Shard(dim={dim}))"

    whole = "(Replicate(), Replicate())"
    if name == "audio":
        return {k: on(3) for k in ("k", "v", "xk", "xv")}
    if cfg.family == "ssm":
        return {"m": on(3) if heads else whole,
                **{k: whole for k in ("s_c", "s_n", "s_h")}}
    return {"m": on(3), "m_tail": on(2), "conv": on(4), "conv_tail": on(3),
            "k": on(3), "v": on(3)}


@pytest.mark.parametrize("case", CASES)
def test_family_caches_placed_by_cache_pspec(results, case):
    """Each state of the placed cache, on every rank, by
    ``rules.cache_pspec``: heads for ``m`` (whole where xlstm's 2 heads
    do not divide 4), channels for ``conv``, heads for ``k``/``v`` and
    ``xk``/``xv``, ``Replicate()`` for the sLSTM carry."""
    name, mesh, _ = case.split()
    want = _want_placements(name, int(mesh.split("x")[1]))
    for r in results["ranks"]:
        assert r["cases"][case]["cache"] == want


@pytest.mark.parametrize("name", WHOLE_CHECKS)
def test_family_step_gathers_no_model_shard_whole(results, name):
    """The axis computes: in the step at (1, 4) no weight the ``model``
    axis shards is gathered whole, the bytes of them a rank holds are a
    quarter of the whole-weight path's, and activations are all-reduced
    over the axis."""
    for r in results["ranks"]:
        tp_, whole = r["whole"][name]["tp"], r["whole"][name]["whole"]
        assert tp_["gathered_whole"] == 0 and tp_["gathers"] > 0
        assert whole["gathered_whole"] == whole["gathers"] > 0
        assert tp_["held_bytes"] * 4 == whole["held_bytes"]
        assert tp_["bytes"].get("all-reduce", 0) > 0


# ---------------------------------------------------------------------------
# the helpers and the mixers, ranks as threads
# ---------------------------------------------------------------------------


class _ThreadAxis:
    """The ranks of one axis as threads; ``group`` is the calling rank.
    Each collective stores the rank's operand, waits for every rank and
    combines the operands in rank order."""

    def __init__(self, n: int):
        self.n = n
        self.barrier = threading.Barrier(n)
        self.slots = [None] * n

    def _exchange(self, x, group):
        self.slots[group] = x.detach().clone()
        self.barrier.wait()
        got = list(self.slots)
        self.barrier.wait()
        return got

    def all_reduce(self, t, op=dist.ReduceOp.SUM, group=None):
        stacked = torch.stack(self._exchange(t, group))
        t.copy_(stacked.amax(0) if op == dist.ReduceOp.MAX
                else stacked.sum(0))

    def all_gather(self, parts, x, group=None):
        for p, got in zip(parts, self._exchange(x, group)):
            p.copy_(got)

    def reduce_scatter_tensor(self, out, x, group=None):
        total = torch.stack(self._exchange(x, group)).sum(0)
        out.copy_(total.chunk(self.n, dim=0)[group])


def _on_threads(n: int, fn, monkeypatch) -> list:
    """``fn(rank, TP)`` on n threads over the stub; its results by rank."""
    axis = _ThreadAxis(n)
    monkeypatch.setattr(tp, "dist", types.SimpleNamespace(
        all_reduce=axis.all_reduce, all_gather=axis.all_gather,
        reduce_scatter_tensor=axis.reduce_scatter_tensor,
        ReduceOp=dist.ReduceOp))
    got, errors = [None] * n, []

    def rank(i):
        try:
            got[i] = fn(i, tp.TP(n, i, i))
        except Exception as e:  # surfaced below, with the rank
            errors.append((i, e))
            axis.barrier.abort()

    threads = [threading.Thread(target=rank, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads), errors
    return got


def _close(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    err = float((got - want).abs().max())
    assert err <= 1e-6 * max(float(want.abs().max()), 1e-30), (what, err)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_part_blocks_equals_slicing_the_whole_product(n, monkeypatch):
    """A column-parallel product of [u | z] moved to each rank's block of
    u and z, against slicing the whole product; the gradients of the
    rank's weight block against the whole gradient's block."""
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal((2, 5, 6))).float()
    w = torch.from_numpy(rng.standard_normal((6, 16))).float()
    probe = torch.from_numpy(rng.standard_normal((2, 5, 16))).float()
    ww = w.clone().requires_grad_(True)
    u, z = (x @ ww).chunk(2, dim=-1)
    want = [u.chunk(n, -1), z.chunk(n, -1)]
    (torch.cat([u, z], -1) * probe).sum().backward()

    def rank(i, t):
        wi = w.chunk(n, -1)[i].clone().requires_grad_(True)
        y = tp.part_blocks(x @ wi, 2, -1, t)
        pu, pz = probe.chunk(2, -1)
        (y * torch.cat([pu.chunk(n, -1)[i], pz.chunk(n, -1)[i]], -1)
         ).sum().backward()
        return y.detach(), wi.grad

    for i, (y, g) in enumerate(_on_threads(n, rank, monkeypatch)):
        _close(y, torch.cat([want[0][i], want[1][i]], -1).detach(), "y")
        _close(g, ww.grad.chunk(n, -1)[i], "grad")


@pytest.mark.parametrize("n", [1, 2, 4])
def test_mean_squares_norm_equals_the_whole_rmsnorm(n, monkeypatch):
    """An RMSNorm over a feature dim split n ways, each rank normalising
    its block by the all-reduced mean square, against the whole
    ``norm_apply``; the input's and the scale's gradients against the
    whole ones' blocks."""
    from repro_torch.models.layers import norm_apply

    rng = np.random.default_rng(10 + n)
    x = torch.from_numpy(rng.standard_normal((3, 4, 16)) * 2).float()
    scale = torch.from_numpy(rng.standard_normal(16)).float()
    probe = torch.from_numpy(rng.standard_normal((3, 4, 16))).float()
    xw, sw = (v.clone().requires_grad_(True) for v in (x, scale))
    want = norm_apply({"scale": sw}, xw, "rmsnorm")
    (want * probe).sum().backward()

    def rank(i, t):
        xi, si = (v.chunk(n, -1)[i].clone().requires_grad_(True)
                  for v in (x, scale))
        y = xi * torch.rsqrt(tp.mean_squares(xi, t) + 1e-6) * si
        (y * probe.chunk(n, -1)[i]).sum().backward()
        return y.detach(), xi.grad, si.grad

    for i, (y, gx, gs) in enumerate(_on_threads(n, rank, monkeypatch)):
        _close(y, want.detach().chunk(n, -1)[i], "y")
        _close(gx, xw.grad.chunk(n, -1)[i], "x grad")
        _close(gs, sw.grad.chunk(n, -1)[i], "scale grad")


#: each mixer's tensor-parallel core, its whole-weight self, its
#: weights' placements on ``model`` ("col": last dim, "row": first, else
#: whole) and those used alike on every rank (the rest take gradients
#: summed over the axis), on reduced xlstm-1.3b (4 heads, and 2: a head
#: spanning two ranks at 4) and zamba2-7b
MIXERS = {
    "mlstm": ("xlstm-1.3b", {}, "mlstm", dict(
        wu="col", wz="col", wq="col", wk="col", wv="col", wo="row"), ()),
    "mlstm_2_heads": ("xlstm-1.3b", dict(n_heads=2, n_kv_heads=2), "mlstm",
                      dict(wu="col", wz="col", wq="col", wk="col", wv="col",
                           wo="row"), ()),
    "slstm": ("xlstm-1.3b", {}, "slstm", dict(w="col", wo="row"),
              ("r", "b")),
    "mamba2": ("zamba2-7b", {}, "mamba2", dict(w_in="col", conv="col",
                                               w_out="row"), ()),
}


def _mixer_weights(cfg, kind: str) -> dict:
    init = getattr(ssm, f"{kind}_init")
    p = init(torch.Generator().manual_seed(7), cfg, torch.float32)
    out = {n: w.detach().clone() for n, w in p._parameters.items()}
    for name, sub in p.named_children():
        out[name] = {k: w.detach().clone() for k, w in sub._parameters.items()}
    # gates away from their initial constants, so every gradient is live
    g = torch.Generator().manual_seed(8)
    for name in ("bi", "bf", "b", "bdt", "a_log"):
        if name in out:
            out[name] = out[name] + 0.1 * torch.randn(out[name].shape,
                                                      generator=g)
    for sub in ("ln", "gn"):
        if sub in out:
            out[sub]["scale"] = 1 + 0.1 * torch.randn(
                out[sub]["scale"].shape, generator=g)
    return out


def _block(w: torch.Tensor, role, n: int, i: int) -> torch.Tensor:
    if role == "col":
        return w.chunk(n, -1)[i]
    if role == "row":
        return w.chunk(n, 0)[i]
    return w


def _leaves(w: dict):
    for name, v in w.items():
        if isinstance(v, dict):
            for k, t in v.items():
                yield f"{name}.{k}", t
        else:
            yield name, v


@pytest.mark.parametrize("seq", [False, True], ids=["none", "seq"])
@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("mixer", list(MIXERS))
def test_mixer_equals_its_whole_weight_self(mixer, n, seq, monkeypatch):
    """The mixer's tensor-parallel core on n threads, each with its
    blocks of the weights (``seq``: its block of 24 positions, a whole
    chunk of 16 and a padded one), against its whole-weight self on the
    same input: the output, the input's gradient and every weight's (the
    blocks, the sums over the ranks of the replicated ones each rank uses
    on its own heads or positions, and those used alike) within 1e-6."""
    arch, over, kind, roles, alike = MIXERS[mixer]
    cfg = configs.reduced(configs.get_config(arch), **over)
    w = _mixer_weights(cfg, kind)
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal((2, 24, cfg.d_model))).float()
    probe = torch.from_numpy(rng.standard_normal(x.shape)).float()
    whole_w = {k: ({a: b.clone().requires_grad_(True) for a, b in v.items()}
                   if isinstance(v, dict) else v.clone().requires_grad_(True))
               for k, v in w.items()}
    xw = x.clone().requires_grad_(True)
    want = getattr(ssm, f"_{kind}_whole")(whole_w, cfg, xw)
    (want * probe).sum().backward()
    core = getattr(ssm, f"_{kind}_tp")

    def rank(i, t):
        local = {}
        for k, v in w.items():
            local[k] = ({a: b.clone().requires_grad_(True)
                         for a, b in v.items()} if isinstance(v, dict) else
                        _block(v, roles.get(k), n, i).clone()
                        .requires_grad_(True))
        xi = (x.chunk(n, 1)[i] if seq else x).clone().requires_grad_(True)
        y = core(local, cfg, xi, t, seq)[0]
        (y * (probe.chunk(n, 1)[i] if seq else probe)).sum().backward()
        return y.detach(), xi.grad, {k: g.grad for k, g in _leaves(local)}

    got = _on_threads(n, rank, monkeypatch)
    _close(torch.cat([y for y, _, _ in got], 1) if seq else got[0][0],
           want.detach(), "output")
    _close(torch.cat([g for _, g, _ in got], 1) if seq else got[0][1],
           xw.grad, "input grad")
    for i in range(n):
        if not seq:
            _close(got[i][0], want.detach(), f"output of rank {i}")
    for name, g in _leaves(whole_w):
        role = roles.get(name)
        grads = [r[2][name] for r in got]
        if role == "col":
            gi = torch.cat(grads, -1)
        elif role == "row":
            gi = torch.cat(grads, 0)
        elif name in alike or (name.startswith("ln.") and not seq):
            for other in grads[1:]:
                _close(other, grads[0], f"{name} alike")
            gi = grads[0]
        else:
            gi = torch.stack(grads).sum(0)
        _close(gi, g.grad, name)
