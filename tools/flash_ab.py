"""Both flash kernels of this checkout against another's, on a card.

Builds ``flash_attention_wgmma.cu`` and ``flash_attention_tf32x3.cu`` from
this checkout and from the checkout at ``--other`` (for example a parent
commit unpacked by ``git archive`` into a directory that ``.gitignore``
lists), then:

* for every head_dim up to 128 both copies of a library instantiate (16
  to 128 in steps of 16, each library's every instantiation there), says
  whether each is the same SASS, instruction for instruction, and counts
  those that differ; it compares the tensor cores' wide kernel of three
  and four owners (head_dim 257 and up) the same way, apart (the rest
  past 128 by time only);
* at the serving prefill shape (B 4, H 32, L 2,048, causal, on the
  model's (B, S, H, D) layout viewed as (B, H, S, D)), for each head_dim
  of ``--head-dims``, in bf16 (the tensor-core route) and in f32 (the
  split-TF32 route), times this library and the other in turns (this,
  other, other, this; each a median of 20 one-launch CUDA-event timings,
  as ``chip_smoke.py`` times), through this checkout's wrapper.

Run from the repo root on a card:
    git archive HEAD~1 | tar -x -C build/parent
    python3 tools/flash_ab.py --other build/parent [--head-dims 64,128,256,512]
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
CSRC = "src/repro_torch/kernels/flash_attention/csrc"
#: the instantiated head_dims whose SASS is compared, by library
SASS_HEAD_DIMS = {"tensor_core": tuple(range(16, 129, 16)),
                  "tf32x3": tuple(range(16, 129, 16))}
#: the tensor cores' wide instantiations of several owners, whose SASS is
#: compared too: (owners, 64-column regions an owner, q.k in rounds)
SASS_WIDE = ((3, 2, 0), (4, 2, 0), (3, 2, 1))


def instantiations(which: str, d: int) -> dict[str, str]:
    """The instantiations of route ``which``'s library at head_dim ``d``:
    a label for each and the part of its mangled name that tells it from
    the others."""
    if which == "tensor_core":
        return {"bf16, 3 parts": f"flash_attention_wgmma_kernelILi{d}ELi3E"}
    name = "flash_attention_tf32x3_kernelI"
    return {"f32, 16-byte copies": f"{name}fLi{d}ELb1E",
            "f32, 4-byte copies": f"{name}fLi{d}ELb0E",
            "bf16": f"{name}13__nv_bfloat16Li{d}ELb0E"}


def instructions(sass: str, d: int, which: str = "tensor_core",
                 label: str = "bf16, 3 parts") -> list[str]:
    """The instructions of one instantiation (route ``which``, head_dim
    ``d``, ``label`` of :func:`instantiations`) in a library's ``cuobjdump
    -sass`` listing, without addresses or encodings; empty where the
    library lacks it."""
    return listed(sass, instantiations(which, d)[label])


def listed(sass: str, function: str) -> list[str]:
    """The instructions of the functions whose (mangled) name holds
    ``function`` in a ``cuobjdump -sass`` listing, without addresses or
    encodings."""
    import chip_smoke

    body = chip_smoke.function_sass(sass, function)
    return [op.strip() for op in re.findall(r"/\*[0-9a-f]{4}\*/\s+([^;]*);",
                                            body)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True,
                    help="root of the checkout to compare with")
    ap.add_argument("--head-dims", default="64,112,128,256,512")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("flash_ab: CUDA is not available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(REPO / "src"), str(REPO)]
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    libs = {}
    for which, (name, sources, signatures, flags) in ops._LIBRARIES.items():
        # the other checkout's library may lack this one's other exports;
        # both copies build with this checkout's flags
        launch = {fn: types for fn, types in signatures.items()
                  if fn.endswith("_launch")}
        libs[which] = {
            "this": ops.load(which),
            "other": _build.load_library(
                f"{name}_other", (args.other / CSRC / sources[0].name,),
                launch, flags)}
    differ = wide_differ = 0
    for which, pair in libs.items():
        sass = {label: chip_smoke.sass_listing(lib._name)
                for label, lib in pair.items()}
        for d in SASS_HEAD_DIMS[which]:
            for label in instantiations(which, d):
                ours, theirs = (instructions(sass[side], d, which, label)
                                for side in pair)
                if not ours or not theirs:
                    if ours or theirs:
                        print(f"{which} head_dim {d} ({label}): only in "
                              f"{'this' if ours else 'the other'} library")
                    continue
                same = ours == theirs
                differ += not same
                print(f"{which} head_dim {d} ({label}): SASS the same: "
                      f"{same} ({len(ours)} and {len(theirs)} instructions)")
                for i, (a, b) in enumerate(zip(ours, theirs)):
                    if a != b:
                        print(f"  first difference, instruction {i}: "
                              f"{a!r} against {b!r}")
                        break
        if which == "tensor_core":
            for owners, regions, multi in SASS_WIDE:
                name = (f"flash_attention_wgmma_wide_kernelILi{ops.P_PARTS}"
                        f"ELi{owners}ELi{regions}ELb{multi}E")
                ours, theirs = (listed(sass[side], name) for side in pair)
                same = ours == theirs
                wide_differ += not same
                print(f"wide kernel, {owners} owners of {regions} regions"
                      f"{' in rounds' if multi else ''}: SASS the same: "
                      f"{same} ({len(ours)} and {len(theirs)} instructions)")
    b, h, length = chip_smoke.SERVE_BATCH, 32, chip_smoke.SERVE_PROMPT
    for d in (int(x) for x in args.head_dims.split(",")):
        for dtype in (torch.bfloat16, torch.float32):
            which = ops.route(dtype, d)
            rng = np.random.default_rng(1)
            q, k, v = (torch.from_numpy(rng.standard_normal((b, length, h, d))
                                        .astype(np.float32))
                       .to("cuda", dtype).transpose(1, 2) for _ in range(3))
            times = {label: [] for label in libs[which]}
            for label in [*times, *reversed(times)]:
                lib = libs[which][label]
                with mock.patch.object(ops, "load",
                                       lambda which=which, lib=lib: lib):
                    times[label].append(chip_smoke.time_ms(
                        torch, lambda: ops.flash_attention(q, k, v)))
            turns = ", ".join(
                f"{label} {' / '.join(f'{t:.4f}' for t in ts)} ms"
                for label, ts in times.items())
            print(f"head_dim {d}, B {b} H {h} L {length} "
                  f"{str(dtype).split('.')[-1]} causal ({which}): {turns} "
                  f"[{smi}]")
            del q, k, v
    print(f"wide instantiations of several owners whose SASS differs: "
          f"{wide_differ}")
    print(f"instantiations to head_dim 128 whose SASS differs: {differ}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
