"""``BENCHMARK.json`` and the files it names, and that a new cell,
configuration, traffic mix or per-layer metric is found from its files
alone, with no edit of the harness."""

from __future__ import annotations

import json
import re

import pytest

import cardbench_tiny as tiny
from cardbench import harness

BENCH = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
HERE = tiny.ROOT / "cardbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
#: the source's names of the widths, which `reduced` may never name
WIDTHS = ("hidden_size", "intermediate_size", "num_attention_heads",
          "num_key_value_heads", "head_dim")


def text_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["command"] == ["python3", "cardbench/run.py"]
    assert BENCH["paths"] == ["cardbench"]
    # 2 + 14 runs a cell, 24 cells, each run its seconds + 60, each cell
    # 180 to compile, 1,200 spare: within 43,200
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(c["name"]) and text_ok(c["source"])
    assert text_ok(c["why"]) and len(c["reduced"]) <= 16
    assert c["file"] == f"cardbench/configs/{c['name']}.json"
    cfg = json.loads((tiny.ROOT / c["file"]).read_text())
    assert cfg["name"] == c["name"]
    assert cfg["reduced"] == c["reduced"]
    assert all(NAME.match(k) for k in c["reduced"])
    assert not set(c["reduced"]) & set(WIDTHS)
    # the file runs the published config but for the keys in `reduced`,
    # named as the source names them
    changed = {src for key, src in cfg["source_keys"].items()
               if cfg[key] != cfg["published"][src]}
    assert changed == set(c["reduced"])
    assert any(c["name"] == w["config"] for w in BENCH["workloads"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_and_its_files(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] == 1 and text_ok(w["why"])
    spec = harness.load_spec(tiny.ROOT, w["name"])
    assert spec.cell["limits"]
    assert hasattr(spec.driver, "compare")
    reported = {m["name"] for m in spec.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert spec.per_layer
    for m in spec.per_layer:
        assert m["moves"] in reported


def test_pairs_and_names_are_unique():
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) \
        == len(CELLS) == len(set(CELLS))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_end_to_end_metrics():
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_per_layer_metrics():
    moved = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert text_ok(m["layer"]) and m["moves"] in moved
        for cell in m["workloads"]:
            assert cell in CELLS
            assert cell in moved[m["moves"]].get("workloads", CELLS)
        assert (HERE / "metrics" / f"{m['name']}.py").exists()
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
            # the whole step's share of the peak beside it
            assert any("mfu" in o["name"] and o["moves"] == m["moves"]
                       for o in BENCH["per_layer"])
    assert len(BENCH["per_layer"]) <= 128


def test_a_new_cell_configuration_traffic_and_metric_are_found(tmp_path):
    root = tiny.build(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    (root / "cardbench" / "metrics" / "tiny.rows_a_batch.py").write_text(
        "def read(r):\n"
        "    return r.window['batches'] and len(r.run.traffic['batches'])\n")
    bench["per_layer"].append({
        "name": "tiny.rows_a_batch", "unit": "rows", "better": "higher",
        "source": "program_counter", "layer": "model step",
        "moves": "ttft_p95_s", "workloads": ["tiny.prefill"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = harness.load_spec(root, "tiny.prefill")
    assert spec.config["name"] == "tiny-deepseek-llm-7b"
    assert spec.config["d_model"] == 64
    assert spec.traffic["driver"] == "prefill_pool"
    assert "tiny.rows_a_batch" in spec.readers
    assert "tiny.rows_a_batch" not in harness.load_spec(
        root, "tiny.decode").readers
    result, _ = tiny.run(root, "tiny.prefill", traced=True)
    assert result["metrics"]["tiny.rows_a_batch"] == {"value": 2.0,
                                                      "unit": "rows"}
    assert result["correct"]


def test_a_cell_file_that_disagrees_is_refused(tmp_path):
    root = tiny.build(tmp_path)
    path = root / "cardbench" / "workloads" / "tiny.decode.json"
    cell = json.loads(path.read_text())
    cell["traffic"] = "tiny.prefill"
    path.write_text(json.dumps(cell))
    with pytest.raises(ValueError):
        harness.load_spec(root, "tiny.decode")
    with pytest.raises(KeyError):
        harness.load_spec(root, "no.such.cell")
