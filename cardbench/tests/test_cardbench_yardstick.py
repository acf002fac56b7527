"""The benchmark's own arithmetic against the numbers it was copied from:
the flash kernel's causal count, the port's analytic prefill count
(``launch/estimate.py``) and ``chip_smoke.py``'s training count."""

from __future__ import annotations

import json

import pytest

import cardbench_tiny as tiny
from cardbench import yardstick

CONFIGS = ("deepseek-llm-7b",)


def layernorm_config() -> dict:
    """The benchmark's configuration with LayerNorm's bias in its norms,
    so that the counts cover both kinds of norm."""
    return dict(config("deepseek-llm-7b"), name="deepseek-llm-7b-ln",
                norm="layernorm")


def config(name: str) -> dict:
    return json.loads((tiny.ROOT / "cardbench" / "configs"
                       / f"{name}.json").read_text())


def test_causal_count_of_the_prefill_shape():
    # B 4, H 32, L 2,048, D 128, causal: the bound chip_smoke.py gives the
    # flash kernel
    flops = yardstick.causal_attention_flops(4, 32, 2048, 2048, 128)
    assert flops == 4 * 32 * (2048 * 2049 // 2) * 4 * 128
    assert flops == pytest.approx(1.3751e11, rel=1e-4)


@pytest.mark.parametrize("lq,lk", [(1, 1), (5, 5), (3, 7), (7, 3), (1, 9),
                                   (64, 1)])
def test_causal_count_is_the_visible_pairs(lq, lk):
    pairs = sum(1 for r in range(lq) for c in range(lk) if c <= r + lk - lq)
    assert yardstick.causal_attention_flops(2, 3, lq, lk, 16) == \
        2 * 3 * pairs * 4 * 16


@pytest.mark.parametrize("length,by_ops", [(1024, False), (2048, True),
                                           (16384, True)])
def test_flash_bound_is_the_larger_of_operations_and_bytes(length, by_ops):
    # causal attention does L / 4 operations a byte: under the card's
    # 295 (989 TFLOP/s over 3.35 TB/s) at 1,024 positions, over it past
    ops = yardstick.causal_attention_flops(16, 32, length, length, 128)
    nbytes = yardstick.attention_bytes(16, 32, 32, length, length, 128)
    assert nbytes == 2 * 128 * 16 * 4 * 32 * length
    bound = yardstick.attention_roofline_s(16, 32, 32, length, length, 128)
    assert bound == max(ops / yardstick.PEAK_BF16_FLOP_S,
                        nbytes / yardstick.HBM_BYTES_S)
    assert (bound == ops / yardstick.PEAK_BF16_FLOP_S) == by_ops


@pytest.mark.parametrize("name", CONFIGS + ("layernorm",))
@pytest.mark.parametrize("batch,seq", [(20, 512), (4, 4096), (4, 2048)])
def test_prefill_count_equals_the_ports_estimate(name, batch, seq):
    from cardbench import program
    from repro_torch.launch.estimate import _fwd_flops

    cfg = layernorm_config() if name == "layernorm" else config(name)
    assert yardstick.prefill_flops(cfg, batch, seq) == _fwd_flops(
        program.model_config(cfg), seq, batch, "prefill")


@pytest.mark.parametrize("name", CONFIGS + ("layernorm",))
def test_weights_counted_are_the_models_but_its_embedding(name):
    from cardbench import program
    from repro_torch.models import param_shapes

    cfg = layernorm_config() if name == "layernorm" else config(name)
    shapes = param_shapes(program.model_config(cfg))
    assert yardstick.matmul_params(cfg) == sum(
        s.size for n, s in shapes.items() if n != "embed")


def test_training_count_of_the_cell():
    cfg = config("deepseek-llm-7b")
    n = yardstick.matmul_params(cfg)
    assert n == 6910365696 - 102400 * 4096
    assert yardstick.train_flops(cfg, 4, 2048) == \
        6.0 * n * 8192 + 12.0 * 30 * 4 * 2048 ** 2 * 32 * 128
