"""The port's sharded paths on gloo process groups on the CPU.

One module fixture starts three worlds at once, each rank a process with
a ``FileStore`` in ``tmp_path`` (no port is opened): 4 ranks (the
sharded loss and train loop at (2, 2), expert parallelism at (2, 2) and
(1, 4), GPipe over a 4-rank stage axis with its gradients, tensor
parallelism on the ``model`` axis at (1, 4) and (2, 2), gradient
compression under a mesh), 2 ranks (the elastic restore across two
layouts) and 1 rank (the (1, 1) mirrors).  The reference's
``moe_apply_ep`` (jitted), its loss, its jitted loss and gradients of
the tensor-parallel cases on each mesh shape and its greedy serving run
beside them in a subprocess with 4 fake XLA devices.  Each rank writes
its results to a JSON file (rank 0 the tensors to ``.npz`` files), and
the counted tests below assert on them.

Tolerances: losses within 1e-3 (absolute, at least; the reference's
``tests/test_sharding.py`` bound) of one device's and of the
reference's; the train loop's losses within 1e-5 relative of the
unsharded loop's; expert parallelism within 1e-5 of the reference's on
the same mesh shape; GPipe's outputs and gradients within 1e-5 of the
sequential stack (f32 throughout); the restore bitwise.  Tensor
parallelism: the loss within 1e-5 relative and every gradient within
1e-4 of its tensor's max-abs of the unsharded port's, and within 1e-3
of the reference's jitted ones on the same mesh shape; greedy tokens
equal to the reference's and the logits of every step within 1e-4.
Compression under a mesh: the reference's round trip of the same global
gradient, exactly.
"""

import functools
import json
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SRC = str(REPO / "src")
MOE = "qwen3-moe-235b-a22b"
EP_MESHES = ("1x1", "2x2", "1x4")
POLICIES = ("ep", "ep_infer")
WORLDS = (("w4", 4), ("w2", 2), ("w1", 1))
LOSS_CFG = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                head_dim=16, d_ff=128, vocab_size=256, dtype="float32")
TRAIN_CFG = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
                 head_dim=16, d_ff=64, vocab_size=128, dtype="float32")
#: the tensor-parallel cases: (arch, overrides of ``reduced``, prompt
#: lengths' cache sizes).  dense is ``LOSS_CFG`` (heads divide 4: the
#: cache splits its heads); gqa has 2 key/value heads at |model| 4 (wk
#: and wv sharded inside heads: K and V gathered; the cache splits its
#: sequence, or at 22 positions stays whole); vlm is llava's text decoder
#: after 8 patches (1 key/value head); moe has 3 experts, which do not
#: divide the axis (tensor parallelism inside the experts)
TP_SPECS = {
    "dense": ("codeqwen1.5-7b", LOSS_CFG, (24,)),
    "gqa": ("codeqwen1.5-7b", dict(LOSS_CFG, n_kv_heads=2), (24, 22)),
    "vlm": ("llava-next-mistral-7b", {}, (24,)),
    "moe": ("qwen3-moe-235b-a22b", dict(n_experts=3), (24,)),
}
TP_MESHES = ("1x4", "2x2")
ACTS = ("none", "seq_model")
TP_CASES = [f"{name} {mesh} {act}" for name in TP_SPECS
            for mesh in TP_MESHES for act in ACTS]
TP_SERVE = [f"{case} {n}" for case in TP_CASES
            for n in TP_SPECS[case.split()[0]][2]]
#: decode steps of the greedy checks
TP_NEW = 4
#: int8 codes at a near tie between two correct backwards, as
#: ``tests/test_torch_training.py`` bounds them
NEAR_TIE_SHARE = 1e-3

_WORKER = textwrap.dedent(r'''
import dataclasses, functools, json, pickle, sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from unittest import mock

from repro_torch.launch import roofline
from repro_torch.launch.mesh import init_from_store, make_local_mesh
from repro_torch.launch.train import TrainLoop
from repro_torch.models import moe, params_from_jax, transformer
from repro_torch.models.layers import Params
from repro_torch.models.transformer import (
    decode_step, loss_fn, param_shapes, prefill)
from repro_torch.sharding import place, rules, tp
from repro_torch.training.checkpoint import restore, save
from repro_torch.training.optimizer import OptConfig, adamw_init
from repro_torch.training.pipeline import pipeline_apply
from repro_torch.training.train_step import (
    _compress_round_trip, batch_rows, make_steps, mesh_loss)

world, rank, size, tmp = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
    Path(sys.argv[4])
data = pickle.loads((tmp / "inputs.pkl").read_bytes())
init_from_store(dist.FileStore(str(tmp / f"store_{world}"), size), rank,
                size, device="cpu")
out = {"backend": dist.get_backend()}


def mesh_of(shape):
    d, m = shape
    return make_local_mesh(d, m, device="cpu")


def ep_outputs(shape):
    """This rank's EP output rows, per policy: written to a .npy beside
    the data index of the rows (None where every rank holds all)."""
    mesh = mesh_of(shape)
    moe.set_mesh(mesh)
    outs = {}
    for policy in ("ep", "ep_infer"):
        cfg = configs.reduced(configs.get_config("qwen3-moe-235b-a22b"),
                              dtype="float32", moe_shard=policy)
        w = {k: torch.from_numpy(v) for k, v in data["moe_w"].items()}
        specs = rules.param_specs(
            cfg, {f"layers.0.moe.{k}": v for k, v in w.items()}, mesh,
            training=policy == "ep")
        p = Params(**w)
        place.distribute_model(
            p, {k: specs[f"layers.0.moe.{k}"] for k in w}, mesh)
        x = torch.from_numpy(data["moe_x"])
        n_data, i = place.mesh_coordinate(mesh, "data")
        rows = None
        if x.shape[0] % n_data == 0:
            x, rows = x.chunk(n_data, dim=0)[i], [i, n_data]
        name = f"ep_{world}_{rank}_{shape[0]}x{shape[1]}_{policy}.npy"
        np.save(tmp / name, moe.moe_apply(p, cfg, x).numpy())
        outs[policy] = [name, rows]
    moe.set_mesh(None)
    return outs


def tp_cfg(spec, **over):
    return configs.reduced(configs.get_config(spec["arch"]), **spec["over"],
                           **over)


def tensors(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def grads_of(cfg, model, batch, mesh):
    """(the global loss, every gradient as a global tensor, as placed)."""
    model.requires_grad_(True)
    names = [n for n, _ in model.named_parameters()]
    axes = () if mesh is None else batch_rows(mesh, batch)[0]
    with place.batch_axes(axes):
        loss, share = mesh_loss(cfg, model, batch, mesh, with_local=True)
        grads = torch.autograd.grad(share, list(model.parameters()))
    return float(loss), dict(zip(names, grads))


def whole(grads):
    return {n: g.full_tensor() if place.is_dtensor(g) else g
            for n, g in grads.items()}


def greedy(cfg, model, batch, n, length):
    with torch.no_grad():
        logits, cache = prefill(cfg, model, batch, length)
        toks, outs = [], [logits]
        for _ in range(n):
            tok = torch.argmax(logits[:, -1, :], dim=-1, keepdim=True)
            toks.append(tok)
            logits, cache = decode_step(cfg, model, cache, tok)
            outs.append(logits)
    return (torch.cat(toks, dim=1).numpy(), torch.stack(outs).numpy(),
            str(cache["k"].placements))


def tp_model(cfg, spec, mesh, training=True):
    model = params_from_jax(cfg, spec["params"], device="cpu")
    return place.distribute_model(model, rules.param_specs(
        cfg, param_shapes(cfg), mesh, training=training), mesh)


def tp_results():
    """Every tensor-parallel case: loss and gradients against the
    unsharded port's (the gradients also to .npz for the reference's),
    and the placed model's greedy serving (to .npz)."""
    out = {}
    for name, spec in data["tp"].items():
        cfg = tp_cfg(spec)
        batch = tensors(spec["loss_batch"])
        plain_loss, plain = grads_of(
            cfg, params_from_jax(cfg, spec["params"], device="cpu"), batch,
            None)
        for shape in ((1, 4), (2, 2)):
            mesh = mesh_of(shape)
            for act in ("none", "seq_model"):
                key = f"{name} {shape[0]}x{shape[1]} {act}"
                c = tp_cfg(spec, act_shard=act)
                loss, grads = grads_of(c, tp_model(c, spec, mesh), batch, mesh)
                grads = whole(grads)
                worst = max(float((grads[n] - g).abs().max()
                                  / g.abs().max().clamp_min(1e-30))
                            for n, g in plain.items())
                r = {"loss": loss, "plain_loss": plain_loss,
                     "grad_vs_plain": worst, "file": f"tp_{len(out)}"}
                s = tp_cfg(spec, act_shard=act, attention_impl="pallas")
                for length in spec["lengths"]:
                    toks, logits, where = greedy(
                        s, tp_model(s, spec, mesh, training=False),
                        tensors(spec["serve_batch"]), data["tp_new"],
                        length + s.n_patches)
                    r[f"cache {length}"] = where
                    if rank == 0:
                        np.savez(tmp / f"{r['file']}_{length}.npz",
                                 tokens=toks, logits=logits)
                if rank == 0:
                    np.savez(tmp / f"{r['file']}.npz",
                             **{n: g.numpy() for n, g in grads.items()})
                out[key] = r
    return out


def tp_collectives():
    """dense at (1, 4): the bytes of weights this rank holds after its
    gathers (of those the ``model`` axis shards), how many of them were
    gathered whole, and the step's collective bytes, on the
    tensor-parallel path and on the whole-weight path (``tp.axis_of``
    answering None, the path before the axis computed)."""
    spec = data["tp"]["dense"]
    cfg, mesh = tp_cfg(spec), mesh_of((1, 4))
    batch = tensors(spec["loss_batch"])
    out = {}
    for path in ("tp", "whole"):
        held = []
        gather = place.local

        def recording(t, *args, **kw):
            got = gather(t, *args, **kw)
            if tp.model_dim(t) is not None:
                held.append((got.numel() * got.element_size(),
                             got.numel() == t.numel()))
            return got

        mode = roofline._comm_mode()
        with mock.patch.object(place, "local", recording), \
                mock.patch.object(transformer, "local", recording), \
                mock.patch.object(tp, "axis_of", (lambda *a: None)
                                  if path == "whole" else tp.axis_of):
            with mode:
                grads_of(cfg, tp_model(cfg, spec, mesh), batch, mesh)
        out[path] = {"held_bytes": sum(b for b, _ in held),
                     "gathered_whole": sum(w for _, w in held),
                     "gathers": len(held), "bytes": dict(mode.bytes)}
    return out


def compression_under_a_mesh(mesh):
    """TRAIN_CFG's gradients at (2, 2) through the sharded step's int8
    round trip, the global gradients and the unsharded step's round trip
    (to .npz), and one compressed train step on the mesh."""
    cfg = configs.reduced(configs.get_config("stablelm-1.6b"),
                          **data["train_cfg"])
    batch = {"tokens": torch.from_numpy(data["loss_tokens"]) % cfg.vocab_size}
    model = init_weights(cfg)
    _, g_plain = grads_of(cfg, model, batch, None)
    model = place.distribute_model(init_weights(cfg), rules.param_specs(
        cfg, param_shapes(cfg), mesh), mesh)
    _, g_mesh = grads_of(cfg, model, batch, mesh)
    back = _compress_round_trip(g_mesh)
    same = all(b.placements == g.placements for b, g in
               zip(back.values(), g_mesh.values()))
    g_mesh, back = whole(g_mesh), whole(back)
    if rank == 0:
        np.savez(tmp / "comp_global.npz",
                 **{n: g.numpy() for n, g in g_mesh.items()})
        np.savez(tmp / "comp_mesh.npz",
                 **{n: g.numpy() for n, g in back.items()})
        np.savez(tmp / "comp_plain.npz", **{
            n: g.numpy() for n, g in _compress_round_trip(g_plain).items()})
    steps = make_steps(cfg, OptConfig(), compress_grads=True, mesh=mesh)
    model.requires_grad_(True)
    _, _, metrics = steps["train_step"](
        model, adamw_init(dict(model.named_parameters())), batch)
    return {"placements_kept": same, "step_loss": float(metrics["loss"])}


def init_weights(cfg):
    return transformer.init_params(cfg, torch.Generator().manual_seed(3),
                                   device="cpu")


def pipeline_grads(smesh):
    """GPipe's gradients (of a fixed probe of its output) against the
    sequential stack's, with plain and with placed stage weights."""
    w, b, x = (torch.from_numpy(data[k]) for k in ("pipe_w", "pipe_b",
                                                   "pipe_x"))
    probe = torch.from_numpy(data["pipe_probe"])

    def stage_fn(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    def run(params, x, pipelined):
        h = (pipeline_apply(stage_fn, params, x, mesh=smesh, axis="stage")
             if pipelined else functools.reduce(
                 lambda h, s: stage_fn({k: v[s] for k, v in params.items()},
                                       h), range(4), x))
        return (h * probe).sum()

    ref = [t.clone().requires_grad_(True) for t in (w, b, x)]
    run({"w": ref[0], "b": ref[1]}, ref[2], False).backward()
    errs = []
    for placed_w in (False, True):
        got = [t.clone() for t in (w, b, x)]
        if placed_w:
            from torch.distributed.tensor import Shard, distribute_tensor
            got[:2] = [distribute_tensor(t, smesh, [Shard(0)]) for t in got[:2]]
        got = [t.requires_grad_(True) for t in got]
        run({"w": got[0], "b": got[1]}, got[2], True).backward()
        errs.append(max(float(((g.grad.full_tensor() if place.is_dtensor(g)
                                else g.grad) - r.grad).abs().max())
                        for g, r in zip(got, ref)))
    return errs


def train_losses(cfg, mesh, ckpt, steps=3):
    loop = TrainLoop(cfg, batch=4, seq=16, ckpt_dir=ckpt, save_every=100,
                     device="cpu", mesh=mesh)
    loop.init_or_restore()
    losses = loop.run(steps, log_every=100)
    moe.set_mesh(None)
    return losses, loop


if world == "w4":
    mesh = mesh_of((2, 2))
    cfg = configs.reduced(configs.get_config("codeqwen1.5-7b"),
                          **data["loss_cfg"])
    model = params_from_jax(cfg, data["loss_params"], device="cpu")
    batch = {"tokens": torch.from_numpy(data["loss_tokens"])}
    out["loss_single"] = float(loss_fn(cfg, model, batch)[0])
    specs = rules.param_specs(cfg, param_shapes(cfg), mesh)
    place.distribute_model(model, specs, mesh)
    out["loss_sharded"] = float(mesh_loss(cfg, model, batch, mesh))
    out["local_param_bytes"] = place.local_bytes(model.parameters())

    tcfg = configs.reduced(configs.get_config("stablelm-1.6b"),
                           **data["train_cfg"])
    out["train_plain"] = train_losses(tcfg, None, tmp / "ck_plain")[0]
    out["train_sharded"], loop = train_losses(tcfg, mesh, tmp / "ck_mesh")
    # restart from the sharded loop's checkpoint: resumes placed
    again = TrainLoop(tcfg, batch=4, seq=16, ckpt_dir=tmp / "ck_mesh",
                      device="cpu", mesh=mesh)
    out["resumed_step"] = again.init_or_restore()
    m0, m1 = loop.state[0], again.state[0]
    out["resumed_equal"] = all(
        torch.equal(a.full_tensor(), b.full_tensor())
        and a.placements == b.placements
        for a, b in zip(m0.parameters(), m1.parameters()))
    moe.set_mesh(None)

    # expert parallelism trains as the plain dispatch when nothing drops
    mcfg = configs.reduced(configs.get_config("qwen3-moe-235b-a22b"),
                           **data["train_cfg"], capacity_factor=8.0)
    out["moe_plain"] = train_losses(mcfg, None, tmp / "ck_moe_plain")[0]
    out["moe_ep"] = train_losses(dataclasses.replace(mcfg, moe_shard="ep"),
                                 mesh, tmp / "ck_moe_ep")[0]

    out["ep"] = {"2x2": ep_outputs((2, 2)), "1x4": ep_outputs((1, 4))}

    smesh = __import__("torch.distributed.device_mesh").distributed \
        .device_mesh.init_device_mesh("cpu", (4,), mesh_dim_names=("stage",))
    w = torch.from_numpy(data["pipe_w"])
    b = torch.from_numpy(data["pipe_b"])
    x = torch.from_numpy(data["pipe_x"])

    def stage_fn(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    ref = x
    for s in range(4):
        ref = stage_fn({"w": w[s], "b": b[s]}, ref)
    got = pipeline_apply(stage_fn, {"w": w, "b": b}, x, mesh=smesh,
                         axis="stage")
    from torch.distributed.tensor import Shard, distribute_tensor
    placed = {k: distribute_tensor(v, smesh, [Shard(0)])
              for k, v in {"w": w, "b": b}.items()}
    got_placed = pipeline_apply(stage_fn, placed, x, mesh=smesh,
                                axis="stage")
    out["pipe_err"] = float((got - ref).abs().max())
    out["pipe_placed_err"] = float((got_placed - ref).abs().max())
    out["pipe_grad_err"] = pipeline_grads(smesh)

    out["tp"] = tp_results()
    out["tp_collectives"] = tp_collectives()
    out["compression"] = compression_under_a_mesh(mesh)

elif world == "w2":
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
            "b": torch.arange(16, dtype=torch.bfloat16),
            "step": torch.tensor(3, dtype=torch.int32)}
    save_mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("data",))
    placed = {"w": distribute_tensor(tree["w"], save_mesh, [Shard(0)]),
              "b": distribute_tensor(tree["b"], save_mesh, [Replicate()]),
              "step": tree["step"]}
    save(tmp / "ck_elastic", 1, placed)
    load_mesh = init_device_mesh("cpu", (1, 2),
                                 mesh_dim_names=("data", "model"))
    where = {"w": (Replicate(), Shard(1)), "b": (Replicate(), Shard(0)),
             "step": None}
    got = restore(tmp / "ck_elastic", 1, tree, mesh=load_mesh,
                  placements=where)
    out["elastic_equal"] = all(
        torch.equal(got[k].full_tensor(), tree[k]) for k in ("w", "b")) \
        and torch.equal(got["step"], tree["step"])
    out["elastic_placements"] = [str(got["w"].placements),
                                 str(got["b"].placements)]
    out["elastic_local"] = list(got["w"].to_local().shape)

else:                                                   # w1: (1, 1)
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = mesh_of((1, 1))
    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8)}
    placed = {"w": distribute_tensor(tree["w"], mesh,
                                     [Replicate(), Replicate()])}
    save(tmp / "ck_mirror", 1, placed)
    got = restore(tmp / "ck_mirror", 1, tree, mesh=mesh_of((1, 1)),
                  placements={"w": (Shard(0), Replicate())})
    out["mirror_equal"] = torch.equal(got["w"].full_tensor(), tree["w"])
    out["mirror_placements"] = str(got["w"].placements)
    tcfg = configs.reduced(configs.get_config("stablelm-1.6b"),
                           **data["train_cfg"])
    out["train_plain"] = train_losses(tcfg, None, tmp / "ck1_plain")[0]
    out["train_sharded"] = train_losses(tcfg, mesh, tmp / "ck1_mesh")[0]
    out["ep"] = {"1x1": ep_outputs((1, 1))}

dist.barrier()
(tmp / f"{world}_{rank}.json").write_text(json.dumps(out))
dist.destroy_process_group()
''')

_JAX = textwrap.dedent(r'''
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import functools, pickle, sys
from pathlib import Path
import jax, jax.numpy as jnp, numpy as np
from repro import configs
from repro.launch.mesh import make_local_mesh
from repro.models import decode_step, loss_fn, moe, param_shapes, prefill
from repro.sharding import rules

tmp = Path(sys.argv[1])
data = pickle.loads((tmp / "inputs.pkl").read_bytes())
cfg = configs.reduced(configs.get_config("codeqwen1.5-7b"),
                      **data["loss_cfg"])
out = {"loss": float(jax.jit(functools.partial(loss_fn, cfg))(
    data["loss_params"], {"tokens": jnp.asarray(data["loss_tokens"])})[0])}
p = {k: jnp.asarray(v) for k, v in data["moe_w"].items()}
for d, m in ((1, 1), (2, 2), (1, 4)):
    mesh = make_local_mesh(d, m)
    moe.set_mesh(mesh)
    out[f"{d}x{m}"] = {}
    for policy in ("ep", "ep_infer"):
        mcfg = configs.reduced(configs.get_config("qwen3-moe-235b-a22b"),
                               dtype="float32", moe_shard=policy)
        with mesh:
            y = jax.jit(lambda p, x: moe.moe_apply(p, mcfg, x))(
                p, jnp.asarray(data["moe_x"]))
        out[f"{d}x{m}"][policy] = np.asarray(y)
    moe.set_mesh(None)


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


# the tensor-parallel cases: jitted loss and gradients with the weights
# placed by the reference's specs on each mesh shape; greedy serving
out["tp"] = {}
for name, spec in data["tp"].items():
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
            out["tp"][f"{name} {d}x{m} {act}"] = (
                float(loss), jax.tree_util.tree_map(np.asarray, grads))
        moe.set_mesh(None)
    cfg = configs.reduced(configs.get_config(spec["arch"]), **spec["over"])
    sb = {k: jnp.asarray(v) for k, v in spec["serve_batch"].items()}
    for length in spec["lengths"]:
        out["tp"][f"{name} {length}"] = greedy(
            cfg, params, sb, data["tp_new"], length + cfg.n_patches)
(tmp / "jax_out.pkl").write_bytes(pickle.dumps(out))
''')


def _tp_inputs(rng) -> dict:
    """Each tensor-parallel case's reference weights and batches: the
    loss's (4, 16) tokens, the greedy run's (2, 16) prompts (after 8
    patches for vlm), and the cache sizes (the patches added)."""
    out = {}
    for i, (name, (arch, over, lengths)) in enumerate(TP_SPECS.items()):
        cfg = jax_configs.reduced(jax_configs.get_config(arch), **over)
        params = jax.jit(functools.partial(jax_init_params, cfg))(
            jax.random.key(10 + i))
        spec = {"arch": arch, "over": over,
                "params": jax.tree_util.tree_map(np.asarray, params),
                "lengths": list(lengths)}
        for key, b in (("loss_batch", 4), ("serve_batch", 2)):
            spec[key] = {"tokens": rng.integers(
                0, cfg.vocab_size, (b, 16)).astype(np.int32)}
            if cfg.family == "vlm":
                spec[key]["patches"] = rng.standard_normal(
                    (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
        out[name] = spec
    return out


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    cfg = jax_configs.reduced(jax_configs.get_config("codeqwen1.5-7b"),
                              **LOSS_CFG)
    params = jax.jit(functools.partial(jax_init_params, cfg))(
        jax.random.key(0))
    mcfg = jax_configs.reduced(jax_configs.get_config(MOE), dtype="float32")
    moe_w = jax.jit(functools.partial(jax_moe.moe_init, cfg=mcfg,
                                      dtype=jnp.float32))(jax.random.key(1))
    return {
        "loss_cfg": LOSS_CFG, "train_cfg": TRAIN_CFG,
        "tp": _tp_inputs(np.random.default_rng(3)), "tp_new": TP_NEW,
        "pipe_probe": np.random.default_rng(4).standard_normal(
            (6, 2, 8)).astype(np.float32),
        "loss_params": jax.tree_util.tree_map(np.asarray, params),
        "loss_tokens": rng.integers(0, cfg.vocab_size,
                                    (4, 16)).astype(np.int32),
        "moe_w": {k: np.asarray(v) for k, v in moe_w.items()},
        "moe_x": np.random.default_rng(2).standard_normal(
            (4, 16, mcfg.d_model)).astype(np.float32),
        "pipe_w": (rng.standard_normal((4, 8, 8)) * 0.3).astype(np.float32),
        "pipe_b": (rng.standard_normal((4, 8)) * 0.1).astype(np.float32),
        "pipe_x": rng.standard_normal((6, 2, 8)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The reference's run and the three worlds, all at once."""
    tmp = tmp_path_factory.mktemp("dist")
    (tmp / "inputs.pkl").write_bytes(pickle.dumps(_inputs()))
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, "-c", _JAX, str(tmp)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)]
    for world, size in WORLDS:
        for rank in range(size):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _WORKER, world, str(rank), str(size),
                 str(tmp)], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
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
    want = pickle.loads((tmp / "jax_out.pkl").read_bytes())
    out = {world: [json.loads((tmp / f"{world}_{r}.json").read_text())
                   for r in range(size)] for world, size in WORLDS}
    out["jax_loss"] = want["loss"]
    out["jax_tp"], out["tmp"] = want["tp"], tmp
    for world, _ in WORLDS:
        for r in out[world]:
            for mesh, per in r.get("ep", {}).items():
                for policy, (name, rows) in per.items():
                    ref = want[mesh][policy]
                    if rows is not None:
                        ref = np.array_split(ref, rows[1], axis=0)[rows[0]]
                    per[policy] = float(np.abs(np.load(tmp / name)
                                               - ref).max())
    return out


def test_every_rank_ran_on_gloo(results):
    for world in ("w4", "w2", "w1"):
        assert {r["backend"] for r in results[world]} == {"gloo"}


def test_sharded_loss_matches_one_device_and_the_reference(results):
    for r in results["w4"]:
        single, sharded = r["loss_single"], r["loss_sharded"]
        assert abs(sharded - single) < 1e-3 * max(1.0, abs(single))
        assert abs(sharded - results["jax_loss"]) < 1e-3 * max(
            1.0, abs(single))
    # each rank holds a quarter of the 2-D sharded weights at (2, 2)
    assert len({r["local_param_bytes"] for r in results["w4"]}) == 1


@pytest.mark.parametrize("world", ["w4", "w1"])
def test_train_loop_on_a_mesh_matches_the_unsharded_loop(results, world):
    for r in results[world]:
        np.testing.assert_allclose(r["train_sharded"], r["train_plain"],
                                   rtol=1e-5)
        assert len(r["train_sharded"]) == 3


def test_train_loop_on_a_mesh_resumes_placed(results):
    for r in results["w4"]:
        assert r["resumed_step"] == 3 and r["resumed_equal"]


def test_expert_parallel_train_loop_matches_the_plain_dispatch(results):
    """With a capacity no token overflows, the all-to-all path computes
    the plain dispatch's function, and its gradients (through the
    all-to-alls, the sequence split and the gathered expert weights)
    train it to the same losses."""
    for r in results["w4"]:
        np.testing.assert_allclose(r["moe_ep"], r["moe_plain"], rtol=1e-5)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mesh", EP_MESHES)
def test_moe_apply_ep_matches_the_reference_on_the_same_mesh(
        results, mesh, policy):
    world = "w1" if mesh == "1x1" else "w4"
    for r in results[world]:
        assert r["ep"][mesh][policy] < 1e-5, r["ep"][mesh]


def test_pipeline_matches_sequential(results):
    """Outputs, and the gradients of the stage weights (plain and placed)
    and of the input, equal to the sequential stack's."""
    for r in results["w4"]:
        assert r["pipe_err"] < 1e-5 and r["pipe_placed_err"] < 1e-5
        assert max(r["pipe_grad_err"]) < 1e-5, r["pipe_grad_err"]


def test_elastic_restore_across_layouts_is_bitwise(results):
    for r in results["w2"]:
        assert r["elastic_equal"]
        assert r["elastic_placements"] == ["(Replicate(), Shard(dim=1))",
                                           "(Replicate(), Shard(dim=0))"]
        assert r["elastic_local"] == [8, 4]


def test_elastic_restore_one_rank_mirror(results):
    """The mirror of the reference's ``test_elastic_reshard_restore``:
    saved replicated on a (1, 1) mesh, restored ``("data", None)``."""
    r, = results["w1"]
    assert r["mirror_equal"]
    assert r["mirror_placements"] == "(Shard(dim=0), Replicate())"


# ---------------------------------------------------------------------------
# tensor parallelism on the model axis
# ---------------------------------------------------------------------------


def _port_named(name: str, tree) -> dict:
    """A reference params-shaped tree of a tensor-parallel case, by the
    port's parameter names."""
    from repro_torch import configs
    from repro_torch.models import params_from_jax

    arch, over, _ = TP_SPECS[name]
    cfg = configs.reduced(configs.get_config(arch), **over)
    return {n: t.detach().numpy() for n, t in
            params_from_jax(cfg, tree, device="cpu").named_parameters()}


@pytest.mark.parametrize("case", TP_CASES)
def test_tensor_parallel_step_matches_the_unsharded_port(results, case):
    """The loss within 1e-5 relative and every gradient within 1e-4 of its
    tensor's max-abs of the same weights unplaced, on every rank."""
    for r in results["w4"]:
        got = r["tp"][case]
        assert abs(got["loss"] - got["plain_loss"]) <= 1e-5 * abs(
            got["plain_loss"]), got
        assert got["grad_vs_plain"] <= 1e-4, got


@pytest.mark.parametrize("case", TP_CASES)
def test_tensor_parallel_step_matches_the_reference_on_the_same_mesh(
        results, case):
    """The reference's jitted loss and gradients with its weights placed
    by its specs on the same mesh shape: within 1e-3 (every gradient of
    its tensor's max-abs)."""
    loss, grads = results["jax_tp"][case]
    want = _port_named(case.split()[0], grads)
    r = results["w4"][0]["tp"][case]
    assert abs(r["loss"] - loss) < 1e-3 * max(1.0, abs(loss))
    got = np.load(results["tmp"] / f"{r['file']}.npz")
    assert sorted(got.files) == sorted(want)
    for name, w in want.items():
        assert np.abs(got[name] - w).max() <= 1e-3 * np.abs(w).max(), name


@pytest.mark.parametrize("case", TP_SERVE)
def test_tensor_parallel_serving_matches_the_reference(results, case):
    """``prefill`` and ``TP_NEW`` greedy ``decode_step``s on the model
    placed by the inference specs, its cache by ``cache_pspec``: tokens
    equal to the reference's (its ``prefill``/``decode_step`` loop, which
    its ``ServingEngine`` runs) and every step's logits within 1e-4.  The
    cache splits its heads where they divide the axis, else its
    sequence where that divides, else each rank holds it whole."""
    name, mesh, act, n = case.split()
    arch, over, _ = TP_SPECS[name]
    m = int(mesh.split("x")[1])
    hkv = over.get("n_kv_heads", 1 if name in ("vlm", "moe") else 4)
    length = int(n) + (8 if name == "vlm" else 0)
    where = ("Shard(dim=3)" if hkv % m == 0 else
             "Shard(dim=2)" if length % m == 0 else "Replicate()")
    toks, logits = results["jax_tp"][f"{name} {n}"]
    for r in results["w4"]:
        assert r["tp"][f"{name} {mesh} {act}"][f"cache {n}"] == \
            f"(Replicate(), {where})"
    r = results["w4"][0]["tp"][f"{name} {mesh} {act}"]
    got = np.load(results["tmp"] / f"{r['file']}_{n}.npz")
    np.testing.assert_array_equal(got["tokens"], toks)
    np.testing.assert_allclose(got["logits"], logits, rtol=0, atol=1e-4)


def test_dense_serving_engine_gives_the_reference_loop_tokens(results):
    """The reference's ``ServingEngine`` gives the greedy tokens its
    ``prefill``/``decode_step`` loop gives, which the serving cases
    compare with."""
    from repro import configs as jcfgs
    from repro.serving import ServeConfig, ServingEngine

    arch, over, (n,) = TP_SPECS["dense"]
    tree = pickle.loads((results["tmp"] / "inputs.pkl").read_bytes())[
        "tp"]["dense"]
    engine = ServingEngine(jcfgs.reduced(jcfgs.get_config(arch), **over),
                           jax.tree_util.tree_map(jnp.asarray,
                                                  tree["params"]),
                           ServeConfig(max_len=n))
    got = engine.generate(tree["serve_batch"]["tokens"], TP_NEW)
    np.testing.assert_array_equal(np.asarray(got),
                                  results["jax_tp"][f"dense {n}"][0])


def test_tensor_parallel_step_gathers_no_model_shard_whole(results):
    """The axis computes: in dense's step at (1, 4) no weight the
    ``model`` axis shards is gathered whole, the bytes of them a rank
    holds are a quarter of the whole-weight path's, and the step's
    collectives all-reduce activations over the axis and all-gather less
    than that path's weight gathers."""
    for r in results["w4"]:
        tp_, whole = r["tp_collectives"]["tp"], r["tp_collectives"]["whole"]
        assert tp_["gathered_whole"] == 0
        assert whole["gathered_whole"] == whole["gathers"] == tp_["gathers"]
        assert tp_["held_bytes"] * 4 == whole["held_bytes"]
        assert tp_["bytes"].get("all-reduce", 0) > 0
        assert tp_["bytes"].get("all-gather", 0) < whole["bytes"]["all-gather"]


def test_compression_under_a_mesh_matches_the_reference(results):
    """The sharded step's int8 round trip equals the reference's
    ``decompress_tree(compress_tree(g))`` of the same global gradients,
    stacked as its leaves, exactly; against the unsharded step's round
    trip, values differ only where a code sits at a near tie (the two
    backwards sum in other orders), at most ``NEAR_TIE_SHARE`` of them.
    The round trip keeps each gradient's placement, and a compressed
    step runs on the mesh."""
    from repro.training import compression as jax_comp
    from repro_torch.sharding.rules import reference_path

    tmp = results["tmp"]
    g, mesh, plain = (np.load(tmp / f"comp_{k}.npz")
                      for k in ("global", "mesh", "plain"))
    stacks: dict = {}
    for name in g.files:
        path, index = reference_path(name)
        stacks.setdefault(path, []).append((index, name))
    back = jax_comp.decompress_tree(jax_comp.compress_tree(
        {path: jnp.stack([g[n] for _, n in sorted(members)])
         for path, members in stacks.items()}))
    for path, members in stacks.items():
        for i, (_, name) in enumerate(sorted(members)):
            np.testing.assert_array_equal(mesh[name], np.asarray(
                back[path][i]), err_msg=name)
    off = sum(int((np.abs(mesh[n] - plain[n])
                   > 1e-6 * np.abs(plain[n]).max()).sum()) for n in g.files)
    total = sum(g[n].size for n in g.files)
    assert off <= NEAR_TIE_SHARE * total, (off, total)
    for r in results["w4"]:
        assert r["compression"]["placements_kept"]
        assert np.isfinite(r["compression"]["step_loss"])
