"""Readings that the limits of a cell's check are set from, on the card.

    python3 cardbench/calibrate.py --workload <cell> --seconds <s> \
        --seeds 11,12,... [--control-seeds 21,22,23] [--half-seeds ...]

For each of ``--seeds``, in one process: the cell's set-up and a short
window of its traffic at its own load (``--seconds``, long enough to
finish the mix's longest requests), then the numbers its check compares
(the lower readings).  For each of ``--control-seeds`` the same, with
the reference in float8 put in the program's place (the control: the
upper readings); for each of ``--half-seeds`` (training) the reference
on half of each batch's rows, the mean taken over them.  Each reading is
one JSON line on standard output; nothing here runs in a benchmark run.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def readings(spec, seed: int, seconds: float, kinds: list,
             device: str = "cuda") -> list:
    """The numbers of each of ``kinds`` (``"program"``, ``"control"``,
    ``"half"``) for one seed, after one set-up and window of the
    program."""
    import torch

    from cardbench import harness

    run = harness.Run(spec, seed, torch.device(device), time.perf_counter())
    drv = spec.driver
    state = drv.prepare(run)
    run.sync()
    setup_s = time.perf_counter() - run.t0
    window = drv.measure(run, state, seconds)
    drv.release(run, state)
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    out = []
    for kind in kinds:
        t = time.perf_counter()
        if kind == "program":
            numbers = drv.compare(run, state)
        elif kind == "control":
            numbers = drv.compare(run, state, quant="fp8")
        else:
            numbers = drv.compare(run, state, half=True)
        out.append({"cell": spec.name, "seed": seed, "kind": kind,
                    "numbers": numbers, "setup_s": setup_s,
                    "e2e": window["e2e"], "check_s": time.perf_counter() - t})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--seeds", type=_seeds, default=[])
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--half-seeds", type=_seeds, default=[])
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from cardbench import harness

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    spec = harness.load_spec(ROOT, args.workload)
    plan: dict = {}
    for kind, seeds in (("program", args.seeds),
                        ("control", args.control_seeds),
                        ("half", args.half_seeds)):
        for s in seeds:
            plan.setdefault(s, []).append(kind)
    for seed, kinds in plan.items():
        for line in readings(spec, seed, args.seconds, kinds):
            print(json.dumps(line), flush=True)
    print(f"calibrate: {time.perf_counter() - T0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
