"""A copy of the benchmark's files with tiny cells added, for the CPU
tests: the configurations cut to two blocks of width 64 (in bf16, the
precision the real cells run), traffic small enough for a second's
window on the CPU, and limits set from this size's own readings (the
real cells' limits come from readings on the card, ``PERF.md``)."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

TINY = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
        "head_dim": 16, "d_ff": 128, "vocab_size": 256}
#: cell -> (the configuration it is cut from and the keys it changes
#: besides the widths, the real cell whose metrics it reports, traffic,
#: the limits at this size: sound runs read 0 (gaps), about 0.01
#: (cache), 0.003 (first gradient) and 0.11 (change: bf16's step at
#: width 64 is a tenth of AdamW's), the float8 control 0.29, 0.16 and
#: 0.03, half the batch 0.18 (first gradient) and 0.30 (change))
CELLS = {
    "tiny.prefill": (("deepseek-llm-7b", {}),
                     "deepseek-llm-7b.prefill_pool", {
        "driver": "prefill_pool", "check_rows": 3, "digest_positions": 2,
        "batches": [{"rows": 2, "length": 16}, {"rows": 1, "length": 32}]},
        {"first_token_gap": 0.1, "kv_cache_rel_err": 0.05}),
    "tiny.decode": (("deepseek-llm-7b", {}),
                    "deepseek-llm-7b.decode_batch", {
        "driver": "decode_batch", "rows": 2, "prompt": 8, "new_tokens": 4,
        "check_rows": 2}, {"decode_token_gap": 0.1}),
    # with LayerNorm, the other kind of norm the port has
    "tiny.train": (("deepseek-llm-7b-8l", {"norm": "layernorm"}),
                   "deepseek-llm-7b-8l.train_2k", dict(
        json.loads((ROOT / "cardbench" / "traffic" / "train_2k.json")
                   .read_text()), batch=2, seq=16, traced_steps=1),
        {"first_grad_gap": 0.015, "change_gap": 0.2}),
}


def build(root: Path) -> Path:
    """The benchmark's files under ``root`` with the tiny cells added as
    new files and new entries; returns ``root``."""
    root = Path(root)
    shutil.copytree(ROOT / "cardbench", root / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    here = root / "cardbench"
    for cell, ((base, changed), real, traffic, limits) in CELLS.items():
        cfg = json.loads((here / "configs" / f"{base}.json").read_text())
        name = f"tiny-{base}" + ("-" + cell.split(".")[-1] if changed
                                 else "")
        cfg.update(TINY, name=name, **changed)
        (here / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        (here / "traffic" / f"{cell}.json").write_text(json.dumps(traffic))
        (here / "workloads" / f"{cell}.json").write_text(json.dumps(
            {"config": name, "traffic": cell, "limits": limits}))
        bench["workloads"].append({"name": cell, "config": name,
                                   "traffic": cell, "chips": 1,
                                   "why": "a CPU test's tiny cell"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if real in m.get("workloads", ()):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run(root: Path, cell: str, seed: int = 2 ** 31 + 11,
        seconds: float = 0.3, traced: bool = False) -> tuple:
    """One run of ``cell`` on the CPU: (result, lines for stderr)."""
    import time

    from cardbench import harness

    t0 = time.perf_counter()
    return harness.run_cell(harness.load_spec(root, cell), seed, seconds,
                            traced, "cpu", t0)
