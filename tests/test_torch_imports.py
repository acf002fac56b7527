"""The port stands alone: it never loads JAX or the JAX package.

A fresh interpreter imports the port's public modules and must find no
``jax*`` and no ``repro``/``repro.*`` module loaded; an AST scan of the
port's sources and of ``chip_smoke.py`` finds no such import."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]

PROBE = """
import json, sys
import repro_torch, repro_torch.core
import repro_torch.kernels.bitmap_support.ops
import repro_torch.kernels.flash_attention.ops
import repro_torch.kernels.decision_walk.ops
import repro_torch.kernels.decision_walk.ref
import repro_torch.core.cluster, repro_torch.core.membership
import repro_torch.core.chaos, repro_torch.core.versions
import repro_torch.configs, repro_torch.models, repro_torch.serving
import repro_torch.serving.loadgen, repro_torch.serving.prefetcher
import repro_torch.launch.serve, repro_torch.launch.train
import repro_torch.models.blocked_attention
import repro_torch.training, repro_torch.training.checkpoint
import repro_torch.training.compression, repro_torch.data
import repro_torch.sharding, repro_torch.sharding.rules
import repro_torch.sharding.place, repro_torch.training.pipeline
import repro_torch.sharding.tp
import repro_torch.launch.mesh, repro_torch.launch.estimate
import repro_torch.launch.roofline, repro_torch.launch.dryrun
import repro_torch.launch.report
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "repro"))))
"""


def test_importing_the_port_loads_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", PROBE], env=env,
                          capture_output=True, text=True, timeout=120,
                          check=False)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def _imported_roots(path: Path) -> list:
    roots = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots += [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.append(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_sources_import_no_jax_and_no_repro(path):
    bad = [r for r in _imported_roots(path)
           if r in ("jax", "jaxlib", "repro")]
    assert bad == []


def test_scan_covers_the_port():
    names = {p.name for p in PORT_FILES}
    assert {"mining.py", "palpatine.py", "ops.py", "ref.py",
            "chip_smoke.py"} <= names
    rel = {str(p.relative_to(REPO)) for p in PORT_FILES}
    port = "src/repro_torch/"
    assert {port + "kernels/flash_attention/ops.py",
            port + "kernels/flash_attention/ref.py",
            port + "configs/base.py", port + "configs/codeqwen15_7b.py",
            port + "models/layers.py", port + "models/attention.py",
            port + "models/transformer.py", port + "models/convert.py",
            port + "models/io.py", port + "serving/engine.py",
            port + "launch/serve.py",
            port + "kernels/decision_walk/decision_walk.py",
            port + "kernels/decision_walk/ops.py",
            port + "kernels/decision_walk/ref.py",
            port + "core/cluster.py", port + "core/membership.py",
            port + "core/chaos.py", port + "core/versions.py",
            port + "serving/loadgen.py",
            port + "serving/prefetcher.py",
            port + "models/blocked_attention.py",
            port + "training/__init__.py", port + "training/optimizer.py",
            port + "training/compression.py",
            port + "training/train_step.py",
            port + "training/checkpoint.py", port + "data/__init__.py",
            port + "data/pipeline.py", port + "launch/train.py",
            port + "sharding/__init__.py", port + "sharding/rules.py",
            port + "sharding/place.py", port + "training/pipeline.py",
            port + "launch/mesh.py", port + "launch/estimate.py",
            port + "launch/roofline.py", port + "launch/dryrun.py",
            port + "launch/report.py"} <= rel
