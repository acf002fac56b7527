"""Rounding of the tensor-core flash-attention kernel on an H100.

The kernel (``flash_attention_wgmma.cu``) feeds the tensor cores f32 p
split into ``ops.P_PARTS`` bf16 parts and sums each K/V tile's P.V from
zero before adding it to O in f32.  This script holds each choice against
f64 attention of the same bf16 inputs and times it:

* p in 1, 2 and 3 bf16 parts (the library's own instantiations);
* with ``--chained``, a variant built from the kernel's source text whose
  P.V products accumulate in O through every tile, as before the tile sums;
* with ``--moe``, chip_smoke's bf16 logits gate on qwen3-moe-235b-a22b at
  full width cut to 8 layers (free routing, seed 0) for each of them.

For each variant and shape it prints the share of bf16 outputs that round
unlike the exact attention and unlike the plain version (f32 attention
rounded once), the signed mean error relative to the mean |output|, the
largest difference from the plain version, and the kernel's time at the
serving prefill shape (B 4, H 32, L 2,048, D 128, causal; medians of 20
one-launch CUDA-event timings, the variants run twice, in turn and back).

Run from the repo root on a card:
    python3 tools/flash_rounding.py [--chained] [--moe]
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np

REPO = Path(__file__).resolve().parents[1]

#: the tile-sum lines of the kernel and their chained counterparts
CHAINED_EDITS = (
    ("for (int i = 0; i < 32; ++i) t[i] = 0.f;   // overwritten (scale_d = 0)",
     "for (int i = 0; i < 32; ++i) o[i] *= alpha[(i / 2) % 2];"),
    ("wgmma_m64nNk16_rs<N>(t, a, dv, kk > 0 || part < kParts - 1);",
     "wgmma_m64nNk16_rs<N>(o, a, dv, 1);"),
    ("o[i] = fmaf(o[i], alpha[(i / 2) % 2], t[i]);", "t[i] = 0.f;"),
)

#: (label, q shape, k/v shape, causal): the llava and codeqwen prefill's
#: head at D 128 with GQA, whisper's cross-attention at D 64, a ragged
#: causal tile, Lq > Lk
SHAPES = (
    ("D128 GQA 32/8 L2048 causal", (1, 32, 2048, 128), (1, 8, 2048, 128),
     True),
    ("D64 416x1500", (1, 20, 416, 64), (1, 20, 1500, 64), False),
    ("D128 GQA 4/2 L1000 causal", (1, 4, 1000, 128), (1, 2, 1000, 128),
     True),
    ("D64 GQA 8/1 300x100 causal", (2, 8, 300, 64), (2, 1, 100, 64), True),
)


def chained_source(source: str) -> str:
    """The kernel's source with P.V chained through O across tiles."""
    for old, new in CHAINED_EDITS:
        if source.count(old) != 1:
            raise ValueError(f"the kernel no longer has the line {old!r}")
        source = source.replace(old, new)
    return source


def exact_attention(torch, q, k, v, causal: bool):
    """f64 attention of the bf16 inputs (scale D^-0.5, end-aligned mask);
    a row that sees no column gives 0, as in the kernel."""
    lq, d, lk = q.shape[2], q.shape[3], k.shape[2]
    group = q.shape[1] // k.shape[1]
    kf = k.double().repeat_interleave(group, 1)
    vf = v.double().repeat_interleave(group, 1)
    s = torch.matmul(q.double(), kf.transpose(-1, -2)) * d ** -0.5
    if causal:
        rows = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
        s = s.masked_fill(rows < torch.arange(lk, device=q.device)[None],
                          float("-inf"))
    return torch.nan_to_num(torch.matmul(torch.softmax(s, -1), vf), nan=0.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chained", action="store_true",
                    help="also the variant that chains P.V through O")
    ap.add_argument("--moe", action="store_true",
                    help="also the moe bf16 logits gate for each variant")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("flash_rounding: CUDA is not available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(REPO / "src"), str(REPO)]
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    name, sources, signatures, _ = ops._LIBRARIES["tensor_core"]
    libs = {"tile sums": ops.load("tensor_core")}
    if args.chained:
        src = _build.BUILD_DIR / "flash_attention_wgmma_chained.cu"
        src.parent.mkdir(parents=True, exist_ok=True)
        src.write_text(chained_source(sources[0].read_text()))
        libs["chained"] = _build.load_library(f"{name}_chained", (src,),
                                              signatures)
    for lib_name in (name, f"{name}_chained"):
        for line in _build.build_logs.get(lib_name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"{lib_name} ptxas: {line.strip()}")
    variants = [("tile sums", n) for n in range(1, ops.P_PARTS + 1)]
    if args.chained:
        variants.append(("chained", ops.P_PARTS))

    def using(variant):
        lib, parts = libs[variant[0]], variant[1]
        return mock.patch.multiple(ops, P_PARTS=parts,
                                   load=lambda which="tensor_core": lib)

    for label, sq, sk, causal in SHAPES:
        rng = np.random.default_rng(0)
        q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   .to("cuda", torch.bfloat16) for s in (sq, sk, sk))
        exact = exact_attention(torch, q, k, v, causal)
        rounded = exact.to(torch.bfloat16)
        plain = ref.flash_attention(q, k, v, causal=causal)
        print(f"\n{label}: the plain version rounds "
              f"{float((plain != rounded).float().mean()):.5f} of its "
              f"outputs unlike the exact attention")
        for variant in variants:
            with using(variant):
                out = ops.flash_attention(q, k, v, causal=causal)
            err = out.double() - exact
            signed = (err * exact.sign()).mean() / exact.abs().mean()
            print(f"  {variant[0]}, p in {variant[1]} parts: unlike exact "
                  f"{float((out != rounded).float().mean()):.5f}, unlike "
                  f"plain {float((out != plain).float().mean()):.5f}; "
                  f"signed error {float(signed):+.3e}; "
                  f"max abs diff from plain "
                  f"{float((out.float() - plain.float()).abs().max()):.3e}")
        del exact, rounded, plain

    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((4, 2048, 32, 128))
                                .astype(np.float32))
               .to("cuda", torch.bfloat16).transpose(1, 2) for _ in range(3))
    times = {}
    for variant in variants + variants[::-1]:
        with using(variant):
            times.setdefault(variant, []).append(chip_smoke.time_ms(
                torch, lambda: ops.flash_attention(q, k, v)))
    sdpa = chip_smoke.time_ms(
        torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True))
    print()
    for variant, t in times.items():
        print(f"B 4 H 32 L 2048 D 128 bf16 causal, {variant[0]}, p in "
              f"{variant[1]} parts: {t[0]:.4f} / {t[1]:.4f} ms")
    print(f"B 4 H 32 L 2048 D 128 bf16 causal, SDPA: {sdpa:.4f} ms")
    del q, k, v

    if args.moe:
        from repro_torch.models import init_params, make_batch

        spec = next(s for s in chip_smoke.FAMILY_PHASES if s.name == "moe")
        cfg = chip_smoke.family_cfg(spec)
        model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                            device="cuda")
        batch = make_batch(cfg, chip_smoke.FAMILY_BATCH, spec.seq_len, seed=0,
                           device="cuda")
        for variant in variants:
            print(f"\nmoe gate, {variant[0]}, p in {variant[1]} parts:")
            with using(variant):
                try:
                    chip_smoke.bf16_logits_gate(
                        torch, ref, cfg, model, batch,
                        spec.seq_len + chip_smoke.FAMILY_NEW, "moe",
                        full=True)
                    print("  passed")
                except AssertionError as e:
                    print(f"  failed: {e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
