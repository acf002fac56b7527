"""Time the build of the port's CUDA libraries under sets of ``nvcc`` flags.

For each flag set given by ``--variant=FLAGS`` (added to
``kernels/_build.NVCC_FLAGS`` alone, not to a library's own flags in
``ops._LIBRARIES``; the first set is the baseline, empty for none) it
builds every library from the checkout's sources into
``build/nvcc_times/``: first one library after another, each with ``nvcc
--time`` (its seconds in the front end, ``cicc`` and ``ptxas``), then all
of them at once, as ``chip_smoke.py``'s phase 1 builds them.  For each
build it prints the wall seconds, the bytes ``ptxas`` spilled, and
whether the library's SASS is the same, function for function, as under
the first set.  A set ``nvcc`` refuses is reported and skipped.

Run from the repo root on a machine with the CUDA toolkit:
    python3 tools/nvcc_times.py --variant= --variant=--split-compile=0
"""

from __future__ import annotations

import argparse
import csv
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "build" / "nvcc_times"


def libraries() -> dict[str, tuple[Path, ...]]:
    """library -> its sources, as the port builds them."""
    from repro_torch.kernels.bitmap_support import ops as bitmap_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops

    libs = {"bitmap_support": tuple(bitmap_ops._SOURCES)}
    libs.update({name: tuple(sources)
                 for name, sources, *_ in fa_ops._LIBRARIES.values()})
    return libs


def functions(so: Path) -> dict[str, list[str]]:
    """Each function's instructions in a library's SASS, without
    addresses or encodings."""
    import chip_smoke

    sass = chip_smoke.sass_listing(str(so))
    return {f.split(None, 1)[0]: re.findall(r"/\*[0-9a-f]{4}\*/\s+([^;]*);", f)
            for f in sass.split("Function : ")[1:]}


def command(nvcc: str, flags: list[str], so: Path, sources) -> list[str]:
    return [nvcc, *flags, "-o", str(so), *(str(s) for s in sources)]


def phases(times_csv: Path) -> str:
    """``nvcc --time``'s seconds by phase, summed (cicc, ptxas, ...): each
    row names the phase second and gives its time in ms after it."""
    total: dict[str, float] = {}
    with open(times_csv, newline="") as f:
        for row in csv.reader(f):
            row = [x.strip() for x in row]
            ms = [float(x) for x in row[2:] if re.fullmatch(r"[\d.]+", x)]
            if len(row) > 2 and ms:
                total[row[1]] = total.get(row[1], 0.0) + ms[0] / 1e3
    return ", ".join(f"{k} {v:.2f} s" for k, v in total.items())


def main(argv=None) -> int:
    sys.path[:0] = [str(REPO / "src"), str(REPO)]
    from repro_torch.kernels import _build
    import chip_smoke

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", action="append", required=True,
                    help="flags added to NVCC_FLAGS, as one string")
    args = ap.parse_args(argv)
    nvcc = _build.nvcc_path()
    print(subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[-1])
    OUT.mkdir(parents=True, exist_ok=True)
    libs = libraries()
    first: dict[str, dict] = {}
    for n, variant in enumerate(args.variant):
        flags = [*_build.NVCC_FLAGS, *variant.split()]
        label = variant or "(NVCC_FLAGS alone)"
        for name, sources in libs.items():
            so, times_csv = OUT / f"lib{name}_{n}.so", OUT / f"{name}_{n}.csv"
            t0 = time.perf_counter()
            proc = subprocess.run([*command(nvcc, flags, so, sources),
                                   "--time", str(times_csv)],
                                  capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                print(f"{label}: nvcc refuses ({proc.returncode}): "
                      f"{(proc.stdout + proc.stderr).strip()[-400:]}")
                break
            log = proc.stdout + proc.stderr
            sass = functions(so)
            same = first.setdefault(name, sass) == sass
            print(f"{label}: {name} alone {seconds:.2f} s ({phases(times_csv)}"
                  f"), spilled {chip_smoke.spilled_bytes(log)} B, "
                  f"{len(sass)} functions, SASS as the first set's: {same}")
        else:
            t0 = time.perf_counter()
            procs = [subprocess.Popen(command(nvcc, flags, OUT / f"lib{name}_"
                                              f"{n}_together.so", sources),
                                      stdout=subprocess.DEVNULL,
                                      stderr=subprocess.DEVNULL)
                     for name, sources in libs.items()]
            rcs = [proc.wait() for proc in procs]
            print(f"{label}: all {len(libs)} at once "
                  f"{time.perf_counter() - t0:.2f} s, rc {rcs}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
