"""The controls of each cell on the card, at the cell's own size: the
reference in float8 put in the program's place (and, for training, the
reference on half of each batch) comes out not correct against the
cell's limits, while the program on the same seed comes out correct.
Each test takes one to two minutes on an H100:

    PYTHONPATH=src python -m pytest -q -m cuda cardbench/tests
"""

from __future__ import annotations

import pytest

import cardbench_tiny as tiny

pytestmark = pytest.mark.cuda

CELLS = {"deepseek-llm-7b.prefill_pool": (6.0, ["control"]),
         "deepseek-llm-7b.decode_batch": (1.0, ["control"]),
         "deepseek-llm-7b-8l.train_2k": (1.0, ["control", "half"])}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_is_not_correct_and_the_program_is(card, cell):
    from cardbench import calibrate, checks, harness

    spec = harness.load_spec(tiny.ROOT, cell)
    seconds, kinds = CELLS[cell]
    got = {r["kind"]: r["numbers"] for r in calibrate.readings(
        spec, 2 ** 31 + 99, seconds, ["program"] + kinds)}
    assert checks.judge(got["program"], spec.cell["limits"])[0], got
    for kind in kinds:
        assert not checks.judge(got[kind], spec.cell["limits"])[0], got
