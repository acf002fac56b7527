"""One run of one cell, found by name in the files of the benchmark.

A cell ``<name>`` is an entry of ``BENCHMARK.json``'s ``workloads`` and
the file ``cardbench/workloads/<name>.json`` (its configuration, its
traffic and the limits of its check).  Its configuration is
``cardbench/configs/<config>.json``, its traffic
``cardbench/traffic/<traffic>.json``, which names a driver,
``cardbench/drivers/<driver>.py``; each per-layer metric ``<metric>`` of
``BENCHMARK.json`` is read by ``cardbench/metrics/<metric>.py``.  A new
cell, configuration, traffic mix or metric is a new file and an entry,
never an edit of this code.

A driver module has ``prepare(run)`` (build the program around the
benchmark's weights and warm every shape the traffic uses),
``measure(run, state, seconds)`` (the window), ``trace_slice(run,
state)`` (a fixed amount of the same work, traced), ``release(run,
state)`` (drop the program's state) and ``compare(run, state)`` (the
numbers the check judges).  A metric module has ``read(readout)``,
which returns the metric's value or None where it finds nothing to
read.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Optional

from . import checks, trace

__all__ = ["FORBIDDEN", "Spec", "Run", "Readout", "load_spec",
           "forbidden_modules", "run_cell"]

#: top-level module names the run may not hold once its window has
#: closed: JAX and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
GIB = 2 ** 30


def forbidden_modules(names=None) -> list:
    """The :data:`FORBIDDEN` top-level names among ``names`` (default
    ``sys.modules``), each compared whole: ``repro_torch`` is not
    ``repro``."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """The Python file ``path`` as a module (a metric's file name may hold
    dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Spec:
    """Everything a run of cell ``name`` reads from the benchmark's
    files."""

    name: str
    chips: int
    cell: dict
    config: dict
    traffic: dict
    driver: ModuleType
    end_to_end: list
    per_layer: list
    readers: dict


def load_spec(root: Path, name: str) -> Spec:
    root = Path(root)
    bench = _json(root / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"BENCHMARK.json has {len(entries)} cells named "
                       f"{name!r}")
    entry = entries[0]
    here = root / "cardbench"
    cell = _json(here / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if cell[key] != entry[key]:
            raise ValueError(f"{name}: BENCHMARK.json's {key} "
                             f"{entry[key]!r}, the cell file's {cell[key]!r}")
    config = _json(here / "configs" / f"{entry['config']}.json")
    traffic = _json(here / "traffic" / f"{entry['traffic']}.json")
    driver = load_module(here / "drivers" / f"{traffic['driver']}.py",
                         f"cardbench_driver_{traffic['driver']}")
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads",
                                                            [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    readers = {m["name"]: load_module(
        here / "metrics" / f"{m['name']}.py",
        "cardbench_metric_" + m["name"].replace(".", "_").replace("-", "_"))
        for m in per_layer}
    return Spec(name, entry["chips"], cell, config, traffic, driver, e2e,
                per_layer, readers)


@dataclasses.dataclass
class Run:
    """One run's settings, as a driver and a metric read them."""

    spec: Spec
    seed: int
    device: object
    t0: float

    @property
    def cfg(self) -> dict:
        return self.spec.config

    @property
    def traffic(self) -> dict:
        return self.spec.traffic

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)


@dataclasses.dataclass
class Readout:
    """What a per-layer metric reads: the run, the window's counters and,
    in a traced run, the traced slice's counters and trace summary."""

    run: Run
    window: dict
    traced: Optional[dict] = None
    summary: Optional[trace.Summary] = None


def run_cell(spec: Spec, seed: int, seconds: float, traced: bool, device,
             t0: float) -> tuple:
    """One run; returns (the result line's object, the compared numbers'
    lines for standard error)."""
    import torch

    run = Run(spec, seed, torch.device(device), t0)
    cuda = run.device.type == "cuda"
    drv = spec.driver
    imports_s = time.perf_counter() - t0
    state = drv.prepare(run)
    run.sync()
    setup_s = time.perf_counter() - t0
    measured = drv.measure(run, state, seconds)
    run.sync()
    peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    summary = slice_counters = None
    if traced:
        slice_counters, summary = trace.capture(
            lambda: drv.trace_slice(run, state), run.sync, cuda)
    drv.release(run, state)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = drv.compare(run, state)
    correct, compared = checks.judge(numbers, spec.cell["limits"])
    correct = correct and measured["failed"] == 0

    if traced:
        readout = Readout(run, measured["counters"], slice_counters, summary)
        metrics = {}
        for m in spec.per_layer:
            value = spec.readers[m["name"]].read(readout)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        e2e = dict(measured["e2e"], setup_s=setup_s,
                   peak_mem_gib=peak / GIB)
        metrics = {m["name"]: {"value": float(e2e[m["name"]]),
                               "unit": m["unit"]} for m in spec.end_to_end}
    device_info = {"platform": "gpu" if cuda else run.device.type,
                   "kind": (torch.cuda.get_device_name(run.device) if cuda
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": measured["attempted"],
              "failed": measured["failed"], "metrics": metrics,
              "device": device_info}
    if traced:
        device_info["busy_s"] = summary.busy_us / 1e6
        device_info["window_s"] = summary.window_us / 1e6
        result["breakdown"] = summary.breakdown()
    result["compared"] = compared
    read = {k: v for k, v in numbers.items() if k not in compared}
    lines = [f"setup_s {setup_s!r}: {imports_s!r} to start and import, "
             f"the rest the driver's prepare"]
    lines += [f"read (no limit) {k}: {v!r}" for k, v in read.items()]
    lines += [f"compared {k}: {v['value']!r} limit {v['limit']!r}"
              for k, v in compared.items()]
    return result, lines
