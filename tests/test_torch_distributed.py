"""The port's sharded paths on gloo process groups on the CPU.

One module fixture starts three worlds at once, each rank a process with
a ``FileStore`` in ``tmp_path`` (no port is opened): 4 ranks (the
sharded loss and train loop at (2, 2), expert parallelism at (2, 2) and
(1, 4), GPipe over a 4-rank stage axis), 2 ranks (the elastic restore
across two layouts) and 1 rank (the (1, 1) mirrors).  The reference's
``moe_apply_ep`` (jitted) and its loss run beside them in a subprocess with 4 fake XLA
devices.  Each rank writes its results to a JSON file, and the counted
tests below assert on them.

Tolerances: losses within 1e-3 (absolute, at least; the reference's
``tests/test_sharding.py`` bound) of one device's and of the
reference's; the train loop's losses within 1e-5 relative of the
unsharded loop's; expert parallelism within 1e-5 of the reference's on
the same mesh shape; GPipe within 1e-5 of the sequential stack (f32
throughout); the restore bitwise.
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

_WORKER = textwrap.dedent(r'''
import dataclasses, json, pickle, sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.launch.mesh import init_from_store, make_local_mesh
from repro_torch.launch.train import TrainLoop
from repro_torch.models import moe, params_from_jax
from repro_torch.models.layers import Params
from repro_torch.models.transformer import loss_fn, param_shapes
from repro_torch.sharding import place, rules
from repro_torch.training.checkpoint import restore, save
from repro_torch.training.pipeline import pipeline_apply
from repro_torch.training.train_step import mesh_loss

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
from repro.models import loss_fn, moe

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
(tmp / "jax_out.pkl").write_bytes(pickle.dumps(out))
''')


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
    for r in results["w4"]:
        assert r["pipe_err"] < 1e-5 and r["pipe_placed_err"] < 1e-5


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
