"""The port's sharding rules against the reference's, with no processes.

For every architecture, on the (16, 16) and (2, 16, 16) abstract meshes,
with ``training`` and ``tp`` on and off: each per-layer parameter spec of
``repro_torch.sharding.rules`` equals the reference's spec at that leaf
without its stack axes, the fallback lines are the reference's once the
port's names and per-layer dims are translated, the batch and cache
specs are equal for every shape, and the bytes a rank holds of the
parameters and of the AdamW moments (with and without ZeRO-1) equal the
reference's to the byte.  Specs compare exactly, as tuples."""

import functools
import re

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.launch.mesh import make_abstract_mesh as jax_abstract  # noqa: E402
from repro.models import io as jax_io  # noqa: E402
from repro.models import param_shapes as jax_param_shapes  # noqa: E402
from repro.sharding import rules as jax_rules  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch.mesh import make_abstract_mesh  # noqa: E402
from repro_torch.models import io  # noqa: E402
from repro_torch.models.transformer import param_shapes  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402

MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@functools.lru_cache(maxsize=None)
def shapes_pair(arch):
    return (jax_param_shapes(jax_configs.get_config(arch)),
            param_shapes(configs.get_config(arch)))


def meshes(name):
    shape, axes = MESHES[name]
    return jax_abstract(shape, axes), make_abstract_mesh(shape, axes)


def by_path(tree, is_leaf=None):
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {jax_rules._path_str(p): leaf for p, leaf in flat}


def is_spec(x):
    return isinstance(x, P)


def strip(spec, n_stack):
    """A reference spec without its leading stack entries."""
    spec = tuple(spec)
    return spec[n_stack:] if spec else ()


def local_bytes(shape, itemsize, spec, sizes):
    n = itemsize
    for dim, size in enumerate(shape):
        entry = spec[dim] if dim < len(spec) else None
        parts = 1
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                parts *= sizes[axis]
        assert size % parts == 0
        n *= size // parts
    return n


def translate(line):
    """A port fallback line in the reference's terms: the path without
    its layer indices, the dim counted with the stack axes."""
    m = re.match(r"(\S+) dim(\d+): (.*)$", line)
    parts = m.group(1).split("/")
    n_stack = sum(p.isdigit() for p in parts)
    path = "/".join(p for p in parts if not p.isdigit())
    return f"{path} dim{int(m.group(2)) + n_stack}: {m.group(3)}"


@pytest.mark.parametrize("tp", [True, False], ids=["tp", "dp"])
@pytest.mark.parametrize("training", [True, False], ids=["train", "infer"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_specs_and_fallbacks_match(arch, mesh_name, training, tp):
    jshapes, tshapes = shapes_pair(arch)
    jmesh, tmesh = meshes(mesh_name)
    want = by_path(jax_rules.param_specs(
        jax_configs.get_config(arch), jshapes, jmesh, training=training,
        tp=tp), is_leaf=is_spec)
    want_report = jax_rules.fallback_report()
    got = rules.param_specs(configs.get_config(arch), tshapes, tmesh,
                            training=training, tp=tp)
    got_report = rules.fallback_report()
    assert list(got) == list(tshapes)
    for name, spec in got.items():
        path, index = rules.reference_path(name)
        assert spec == strip(want[path], len(index)), name
        for axis in spec:
            assert axis is None or isinstance(axis, str)
    assert {translate(line) for line in got_report} == set(want_report)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_batch_and_cache_specs_match(arch, mesh_name):
    jcfg, tcfg = jax_configs.get_config(arch), configs.get_config(arch)
    jmesh, tmesh = meshes(mesh_name)
    for shape_name, jshape in jax_configs.SHAPES.items():
        tshape = configs.SHAPES[shape_name]
        for all_axes in (False, True):
            want = jax_rules.batch_specs_pspec(jcfg, jshape, jmesh,
                                               all_axes=all_axes)
            got = rules.batch_specs_pspec(tcfg, tshape, tmesh,
                                          all_axes=all_axes)
            assert got == {k: tuple(v) for k, v in want.items()}, (
                shape_name, all_axes)
        if jshape.kind != "decode":
            continue
        jcache = jax_io.cache_specs(jcfg, jshape)
        tcache = io.cache_specs(tcfg, tshape)
        want = by_path(jax_rules.cache_pspec(jcfg, jshape, jmesh, jcache),
                       is_leaf=is_spec)
        got = rules.cache_pspec(tcfg, tshape, tmesh, tcache)
        assert got == {k: tuple(v) for k, v in want.items()}, shape_name


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_bytes_per_rank_match(arch, mesh_name):
    """Parameters (train and inference specs) and moments (with and
    without ZeRO-1): the bytes one rank holds equal the reference's,
    though ZeRO-1 may shard another dim than the reference's layer
    axis."""
    jshapes, tshapes = shapes_pair(arch)
    jmesh, tmesh = meshes(mesh_name)
    sizes = dict(zip(MESHES[mesh_name][1], MESHES[mesh_name][0]))
    jcfg, tcfg = jax_configs.get_config(arch), configs.get_config(arch)
    jleaves = by_path(jshapes)
    for training, tp, zero1 in ((True, True, False), (False, True, False),
                                (True, False, True), (True, True, True)):
        jspec = jax_rules.param_specs(jcfg, jshapes, jmesh,
                                      training=training, tp=tp)
        tspec = rules.param_specs(tcfg, tshapes, tmesh, training=training,
                                  tp=tp)
        jopt = jax_rules.opt_pspec(jspec, shapes=jshapes, mesh=jmesh,
                                   zero1=zero1)
        topt = rules.opt_pspec(tspec, shapes=tshapes, mesh=tmesh,
                               zero1=zero1)
        assert topt["step"] == () and tuple(jopt["step"]) == ()
        for what, jt, tt, itemsize in (
                ("params", jspec, tspec, None),
                ("m", jopt["m"], topt["m"], 4), ("v", jopt["v"], topt["v"], 4)):
            jflat = by_path(jt, is_leaf=is_spec)
            want = sum(local_bytes(jleaves[p].shape,
                                   itemsize or jleaves[p].dtype.itemsize,
                                   s, sizes) for p, s in jflat.items())
            got = sum(local_bytes(tshapes[n].shape,
                                  itemsize or tshapes[n].dtype.itemsize,
                                  s, sizes) for n, s in tt.items())
            assert got == want, (what, training, tp, zero1)


# -- the reference's own checks of tests/test_sharding.py, on the port -----

PROD = make_abstract_mesh((16, 16), ("data", "model"))


def test_dense_tp_fsdp_specs():
    cfg = configs.get_config("codeqwen1.5-7b")
    specs = rules.param_specs(cfg, param_shapes(cfg), PROD)
    assert specs["layers.0.attn.wq"] == ("data", "model")
    assert specs["layers.0.attn.wo"] == ("model", "data")
    assert specs["layers.0.mlp.w1"] == ("data", "model")
    assert specs["layers.0.mlp.w2"] == ("model", "data")
    assert specs["embed"] == ("model", "data")
    assert specs["layers.0.ln1.scale"] == ()        # replicated


def test_moe_expert_parallel_when_divisible():
    cfg = configs.get_config("qwen3-moe-235b-a22b")  # 128 % 16 == 0 -> EP
    specs = rules.param_specs(cfg, param_shapes(cfg), PROD)
    assert specs["layers.0.moe.w1"] == ("model", "data", None)
    cfg2 = configs.get_config("grok-1-314b")         # 8 experts -> TP on F
    specs2 = rules.param_specs(cfg2, param_shapes(cfg2), PROD)
    assert specs2["layers.0.moe.w1"] == (None, "data", "model")


def test_divisibility_fallback_reported():
    cfg = configs.get_config("whisper-large-v3")     # vocab 51866 % 16
    specs = rules.param_specs(cfg, param_shapes(cfg), PROD)
    assert specs["embed"][0] is None
    assert any("embed" in r for r in rules.fallback_report())


def test_no_axis_used_twice():
    for arch in ("yi-34b", "qwen3-moe-235b-a22b", "xlstm-1.3b",
                 "zamba2-7b"):
        cfg = configs.get_config(arch)
        for spec in rules.param_specs(cfg, param_shapes(cfg),
                                      PROD).values():
            axes = [a for a in spec if a is not None]
            assert len(axes) == len(set(axes)), spec


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert rules.placements(mesh, ("model", "data")) == (
        Replicate(), Shard(1), Shard(0))
    assert rules.placements(mesh, (("pod", "data"), None)) == (
        Shard(0), Shard(0), Replicate())
    assert rules.placements(mesh, {"a": (), "b": {"c": (None, "model")}}) == {
        "a": (Replicate(),) * 3,
        "b": {"c": (Replicate(), Replicate(), Shard(1))}}


@pytest.mark.parametrize("name, want", [
    ("embed", ("embed", ())),
    ("layers.3.attn.wq", ("layers/attn/wq", (3,))),
    ("mamba_sb.1.2.w_in", ("mamba_sb/w_in", (1, 2))),
    ("shared_attn.ln1.scale", ("shared_attn/ln1/scale", ())),
])
def test_reference_path(name, want):
    assert rules.reference_path(name) == want
