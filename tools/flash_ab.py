"""The tensor-core flash kernel of this checkout against another's, on a card.

Builds ``flash_attention_wgmma.cu`` from this checkout and from the
checkout at ``--other`` (for example a parent commit unpacked by ``git
archive`` into a directory that ``.gitignore`` lists), then, at the
serving prefill shape (B 4, H 32, L 2,048, causal, bf16, on the model's
(B, S, H, D) layout viewed as (B, H, S, D)), for each head_dim:

* times each library that is instantiated there, in turns (this, other,
  other, this; each a median of 20 one-launch CUDA-event timings, as
  ``chip_smoke.py`` times), through this checkout's wrapper;
* says whether the two instantiations (3 bf16 parts of p) are the same
  SASS, instruction for instruction;
* at a head_dim the other library lacks, times this checkout's
  split-TF32 kernel in bf16 there in its place, in the same turns.

Run from the repo root on a card:
    git archive HEAD~1 | tar -x -C build/parent
    python3 tools/flash_ab.py --other build/parent [--head-dims 64,112,128]
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np

REPO = Path(__file__).resolve().parents[1]
SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention_wgmma.cu"


def instructions(sass: str, d: int) -> list[str]:
    """The instructions of the head_dim ``d``, 3-part instantiation in a
    library's ``cuobjdump -sass`` listing, without addresses or
    encodings."""
    import chip_smoke

    body = chip_smoke.function_sass(
        sass, f"flash_attention_wgmma_kernelILi{d}ELi3E")
    return [op.strip() for op in re.findall(r"/\*[0-9a-f]{4}\*/\s+([^;]*);",
                                            body)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True,
                    help="root of the checkout to compare with")
    ap.add_argument("--head-dims", default="64,112,128")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("flash_ab: CUDA is not available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(REPO / "src"), str(REPO)]
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name, _, signatures = ops._LIBRARIES["tensor_core"]
    libs = {"this": ops.load("tensor_core"),
            "other": _build.load_library(f"{name}_other",
                                         (args.other / SOURCE,), signatures)}
    sass = {label: chip_smoke.sass_listing(lib._name)
            for label, lib in libs.items()}
    b, h, length = chip_smoke.SERVE_BATCH, 32, chip_smoke.SERVE_PROMPT
    for d in (int(x) for x in args.head_dims.split(",")):
        rng = np.random.default_rng(1)
        q, k, v = (torch.from_numpy(rng.standard_normal((b, length, h, d))
                                    .astype(np.float32))
                   .to("cuda", torch.bfloat16).transpose(1, 2)
                   for _ in range(3))
        variants = {}
        for label, lib in libs.items():
            if lib.flash_attention_wgmma_smem_bytes(d):
                variants[label] = mock.patch.object(
                    ops, "load", lambda which="tensor_core", lib=lib: lib)
            else:
                variants["tf32x3"] = mock.patch.object(
                    ops, "route", lambda dtype, head_dim: "tf32x3")
        times = {label: [] for label in variants}
        for label in [*variants, *reversed(variants)]:
            with variants[label]:
                times[label].append(chip_smoke.time_ms(
                    torch, lambda: ops.flash_attention(q, k, v)))
        same = ""
        if "other" in variants:
            ours, theirs = (instructions(sass[label], d) for label in libs)
            same = (f"; SASS the same: {ours == theirs} ({len(ours)} and "
                    f"{len(theirs)} instructions)")
        print(f"head_dim {d}, B {b} H {h} L {length} bf16 causal: " + ", ".join(
            f"{label} {' / '.join(f'{t:.4f}' for t in ts)} ms"
            for label, ts in times.items()) + same + f" [{smi}]")
        del q, k, v
    return 0


if __name__ == "__main__":
    sys.exit(main())
