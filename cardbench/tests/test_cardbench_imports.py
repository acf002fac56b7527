"""A run never loads JAX or the JAX package, and the reference imports
nothing of the program."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

import cardbench_tiny as tiny
from cardbench import harness

HERE = tiny.ROOT / "cardbench"


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(
        ["jax.numpy", "repro.core.cache", "numpy", "jaxlib", "flax.linen"]) \
        == ["flax", "jax", "jaxlib", "repro"]
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.models", "jaxtyping", "reprox"]) == []


_RUN = """
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src", sys.argv[1] + "/cardbench/tests"]
import cardbench_tiny as tiny
from cardbench import harness
result, _ = tiny.run(tiny.build(sys.argv[2]), sys.argv[3], traced=True)
print(json.dumps({"correct": result["correct"],
                  "loaded": sorted({m.split(".")[0] for m in sys.modules}),
                  "forbidden": harness.forbidden_modules()}))
"""


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_a_run_loads_no_jax_and_no_jax_package(tmp_path, cell):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _RUN, str(tiny.ROOT),
                          str(tmp_path / "bench"), cell],
                         capture_output=True, text=True, env=env,
                         timeout=600, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"]
    assert "repro_torch" in got["loaded"]
    assert got["forbidden"] == []
    assert not {"jax", "jaxlib", "flax", "repro"} & set(got["loaded"])


def imports_of(path) -> set:
    """Top-level names of the absolute imports in a Python file."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert imports_of(path) <= {"__future__", "contextlib", "math", "typing",
                                "torch"}


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        assert not imports_of(path) & {"jax", "jaxlib", "flax", "repro"}, \
            path


def test_the_command_refuses_without_a_card(tmp_path):
    # the driver's command, from a checkout, on a machine with no card
    out = subprocess.run(
        [sys.executable, "cardbench/run.py", "--workload",
         "deepseek-llm-7b.prefill_pool", "--seed", str(2 ** 31 + 5),
         "--seconds", "1", "--trace", "0"], cwd=tiny.ROOT,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA card" in out.stderr
