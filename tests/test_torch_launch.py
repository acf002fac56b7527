"""The port's launch tools against the reference's.

``cell_estimate``, ``model_flops`` and ``auto_flags`` equal the
reference's on every architecture and shape (exactly: the same
arithmetic on the same integer counts), ``bubble_fraction`` is equal,
and a ``run_cell`` completes for one dense and one moe cell under a
256-rank fake process group, its collective term counted."""

import json

import pytest

pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.launch import dryrun as jax_dryrun  # noqa: E402
from repro.launch.estimate import cell_estimate as jax_estimate  # noqa: E402
from repro.training.pipeline import bubble_fraction as jax_bubble  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun, report, roofline  # noqa: E402
from repro_torch.launch.estimate import cell_estimate  # noqa: E402
from repro_torch.training.pipeline import bubble_fraction  # noqa: E402


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_estimates_and_model_flops_match(arch):
    for shape_name, jshape in jax_configs.SHAPES.items():
        jcfg = jax_configs.get_config(arch)
        tcfg = configs.get_config(arch)
        tshape = configs.SHAPES[shape_name]
        assert cell_estimate(tcfg, tshape) == jax_estimate(jcfg, jshape)
        assert dryrun.model_flops(tcfg, tshape) == jax_dryrun.model_flops(
            jcfg, jshape)
        assert dryrun.cell_is_applicable(tcfg, tshape) == \
            jax_dryrun.cell_is_applicable(jcfg, jshape)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_auto_flags_match(arch):
    for shape_name, jshape in jax_configs.SHAPES.items():
        for n_chips in (256, 512):
            assert dryrun.auto_flags(
                configs.get_config(arch), configs.SHAPES[shape_name],
                n_chips) == jax_dryrun.auto_flags(
                    jax_configs.get_config(arch), jshape, n_chips)


def test_bubble_fraction():
    for s, m in ((1, 8), (4, 12), (4, 4), (16, 64)):
        assert bubble_fraction(s, m) == jax_bubble(s, m)
    assert abs(bubble_fraction(4, 12) - 3 / 15) < 1e-12


def test_roofline_rates_are_the_h100_sheet():
    hw = roofline.HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw) == (989e12, 3.35e12,
                                                      450e9)


@pytest.mark.parametrize("arch, shape, kinds", [
    ("codeqwen1.5-7b", "train_4k", ("all-gather", "reduce-scatter")),
    ("qwen3-moe-235b-a22b", "prefill_32k", ("all-gather", "all-to-all")),
])
def test_run_cell_under_a_fake_group(arch, shape, kinds, tmp_path):
    res = dryrun.run_cell(arch, shape, False, auto_opt=True)
    assert res["status"] == "ok", res.get("error")
    assert res["n_chips"] == 256 and res["mesh"] == "pod16x16"
    mem = res["memory"]
    assert mem["argument_bytes_per_device"] == sum(
        v for k, v in mem.items() if k != "argument_bytes_per_device")
    coll = res["roofline"]["coll_breakdown"]
    for kind in kinds:
        assert coll[kind] > 0 and coll["_counts"][kind] > 0
    assert res["roofline"]["collective_s"] == pytest.approx(
        res["roofline"]["coll_bytes_per_device"] / 450e9)
    assert not __import__("torch").distributed.is_initialized()
    (tmp_path / "cell.json").write_text(json.dumps(res))
    table = report.fmt_table(report.load(tmp_path))
    assert arch in table and res["roofline"]["dominant"] in table


def test_rank_bytes_of_a_one_rank_mesh_are_the_whole_step():
    """At (1, 1) a rank holds everything: the parameters' bytes, two f32
    moments a parameter and the step, and the batch."""
    from repro_torch.launch.mesh import make_abstract_mesh
    from repro_torch.models.transformer import param_shapes

    cfg = configs.get_config("stablelm-1.6b")
    shape = configs.ShapeConfig("train_2k", 2048, 4, "train")
    got = dryrun.rank_bytes(cfg, shape,
                            make_abstract_mesh((1, 1), ("data", "model")))
    shapes = param_shapes(cfg)
    assert got["param_bytes_per_device"] == sum(
        s.nbytes for s in shapes.values())
    assert got["opt_bytes_per_device"] == 4 + 8 * sum(
        s.size for s in shapes.values())
    assert got["batch_bytes_per_device"] == 4 * 2048 * 4
