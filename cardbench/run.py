"""Run one cell of the on-card benchmark of ``repro_torch`` once.

    python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA card.  The port
is imported from the checkout's ``src/``; its kernels are built there
(``build/kernels/``, at first use) and every other cache goes under
``build/cardbench_cache/``.  Set-up makes the weights and prompts from
the seed and warms every shape the cell's traffic uses; the window then
runs the traffic for ``--seconds`` (whole batches or steps); with
``--trace 1`` a fixed slice of the same work follows under
``torch.profiler``.  Once the program's state is freed the plain
reference judges what the window produced.

The last lines on standard error give each compared number beside its
limit; the last line on standard output is the result, with the cell's
end-to-end metrics (``--trace 0``) or its per-layer ones (``--trace
1``).  The run exits with another code than 0 and prints no result
without enough cards, where the port is missing, or where a module of
JAX or of the JAX package is loaded once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: cache directories of the libraries the program may use, each at a
#: fixed path inside the checkout
CACHES = {"TRITON_CACHE_DIR": "triton",
          "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TORCHINDUCTOR_CACHE_DIR": "inductor",
          "CUDA_CACHE_PATH": "cuda"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "cardbench_cache" / sub)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from cardbench import harness

    spec = harness.load_spec(ROOT, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < spec.chips:
        print(f"{args.workload} needs {spec.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (the system under test, from src/)

    result, lines = harness.run_cell(spec, args.seed, args.seconds,
                                     bool(args.trace), "cuda", T0)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"the run loaded {', '.join(loaded)}: the port must not",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
