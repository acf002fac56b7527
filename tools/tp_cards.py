"""Tensor parallelism across the cards of one host, on NCCL.

    python3 tools/tp_cards.py [--cards 4]
    python3 tools/tp_cards.py --device cpu --reduced   # 4 gloo ranks

Starts one process a card (a ``FileStore`` in a temporary directory, no
port), each running the port's tensor-parallel paths on a mesh of all
the cards:

1. the tensor-parallel cases of ``tests/test_torch_distributed.py`` and
   ``tests/test_torch_tensor_parallel_families.py`` at (1, n) and (2, n /
   2), with and without sequence parallelism, in f32 with TF32 off
   (reduced dense, GQA with 2 key/value heads, vlm, moe with 3 experts,
   whisper, xlstm at 4 and at 2 heads, zamba2 at 5 layers): the loss
   within 1e-5 relative and every gradient
   within 1e-4 of its tensor's max-abs of the same weights unplaced on
   the same card, and the placed model's greedy ``prefill`` and 4
   ``decode_step``s (its cache placed by ``rules.cache_pspec``) giving
   the unplaced model's tokens, its logits within 1e-4;
2. stablelm-1.6b at full width and depth (bf16, ``remat="full"``, batch
   4 x 2,048 on one fixed batch, ``"reference"`` attention) through
   ``TrainLoop(mesh=)`` at (1, n): the first loss against the unsharded
   loop's on one card (rank 0, before), then a warm step's seconds,
   peak memory, and one profiled step's busy share and NCCL kernel time;
3. zamba2-7b at full size in bf16 (``attention_impl="pallas"``), placed by
   the inference specs at (1, n): one prefill's every-position logits of
   4 x 2,048 tokens held to the bf16 gate of ``chip_smoke.py``'s phase 7
   against one card's (rank 0, before: the ``"reference"`` attention path,
   and the floor, the kernel's plain version in its place; beside it,
   unheld, the deviation that moving the embeddings by one bf16 unit
   roundoff causes), a warm
   prefill's seconds, peak memory a rank and one profiled prefill's NCCL
   kernel time; then in f32 at 13 layers (phase 15's cut) the placed
   model's every-position logits against one card's within 1e-3
   (``chip_smoke.F32_LOGITS_TOL``).

Rank 0 prints the card, its power limit and one JSON line of the results;
a failed check exits non-zero.  ``--device cpu`` runs the same on gloo
with ``--reduced`` widths, to rehearse without cards.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CASES = {
    "dense": ("codeqwen1.5-7b", dict(n_layers=2, d_model=64, n_heads=4,
                                     n_kv_heads=4, head_dim=16, d_ff=128,
                                     vocab_size=256, dtype="float32")),
    "gqa": ("codeqwen1.5-7b", dict(n_layers=2, d_model=64, n_heads=4,
                                   n_kv_heads=2, head_dim=16, d_ff=128,
                                   vocab_size=256, dtype="float32")),
    "vlm": ("llava-next-mistral-7b", {}),
    "moe": ("qwen3-moe-235b-a22b", dict(n_experts=3)),
    "audio": ("whisper-large-v3", {}),
    "ssm": ("xlstm-1.3b", {}),
    "ssm2": ("xlstm-1.3b", dict(n_heads=2, n_kv_heads=2)),
    "hybrid": ("zamba2-7b", dict(n_layers=5)),
}
PREFILL = dict(arch="zamba2-7b", batch=4, seq=2048, f32_layers=13)
TRAIN = dict(batch=4, seq=2048, steps=3, opt={"lr": 1e-3, "warmup_steps": 2,
                                              "total_steps": 1000})


def _grads(torch, cfg, model, batch, mesh):
    from repro_torch.sharding import place
    from repro_torch.training.train_step import batch_rows, mesh_loss

    model.requires_grad_(True)
    axes = () if mesh is None else batch_rows(mesh, batch)[0]
    with place.batch_axes(axes):
        loss, share = mesh_loss(cfg, model, batch, mesh, with_local=True)
        grads = torch.autograd.grad(share, list(model.parameters()))
    return float(loss), [g.full_tensor() if place.is_dtensor(g) else g
                         for g in grads]


def _greedy(torch, cfg, model, batch, length):
    from repro_torch.models import decode_step, prefill

    with torch.no_grad():
        logits, cache = prefill(cfg, model, batch, length)
        outs, toks = [logits], []
        for _ in range(4):
            tok = logits[:, -1].argmax(-1, keepdim=True)
            toks.append(tok)
            logits, cache = decode_step(cfg, model, cache, tok)
            outs.append(logits)
    return torch.cat(toks, 1), torch.stack(outs)


def tp_cases(torch, n: int, device: str) -> dict:
    """Part 1 (module docstring): the worst differences of each case."""
    from repro_torch import configs
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import init_params, make_batch
    from repro_torch.models.transformer import param_shapes
    from repro_torch.sharding import place, rules

    out = {}
    for shape in ((1, n), (2, n // 2)):
        mesh = make_local_mesh(*shape, device=device)
        for name, (arch, over) in CASES.items():
            for act in ("none", "seq_model"):
                cfg = configs.reduced(configs.get_config(arch), **over,
                                      act_shard=act)
                extra = cfg.n_patches if cfg.family == "vlm" else 0
                batch = make_batch(cfg, 4, 16 + extra, seed=1, device=device)

                def model(training=True, placed=True, cfg=cfg, mesh=mesh):
                    m = init_params(cfg, torch.Generator(device).manual_seed(
                        0), device=device)
                    if placed:
                        place.distribute_model(m, rules.param_specs(
                            cfg, param_shapes(cfg), mesh,
                            training=training), mesh)
                    return m

                plain_loss, plain = _grads(torch, cfg, model(placed=False),
                                           batch, None)
                loss, grads = _grads(torch, cfg, model(), batch, mesh)
                grad_rel = max(float((a - b).abs().max() / b.abs().max())
                               for a, b in zip(grads, plain))
                serve = {k: v[:2] for k, v in batch.items()}
                want = _greedy(torch, cfg, model(placed=False), serve,
                               24 + extra)
                got = _greedy(torch, cfg, model(training=False), serve,
                              24 + extra)
                out[f"{name} {shape[0]}x{shape[1]} {act}"] = {
                    "loss_rel": abs(loss - plain_loss) / abs(plain_loss),
                    "grad_rel": grad_rel,
                    "tokens_equal": bool(torch.equal(got[0], want[0])),
                    "logits_diff": float((got[1] - want[1]).abs().max())}
    return out


def train_step(torch, n: int, device: str, rank: int, reduced: bool,
               tmp: Path) -> dict:
    """Part 2 (module docstring)."""
    import torch.distributed as dist

    from chip_smoke import kernel_total, profiled
    from repro_torch import configs
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import TrainLoop
    from repro_torch.training.optimizer import OptConfig

    cfg = configs.get_config("stablelm-1.6b")
    if reduced:
        cfg = configs.reduced(cfg, dtype="bfloat16", head_dim=64)
    cfg = dataclasses.replace(cfg, attention_impl="reference", remat="full")
    batch, seq = (2, 64) if reduced else (TRAIN["batch"], TRAIN["seq"])

    def loop(mesh, where):
        lp = TrainLoop(cfg, batch=batch, seq=seq, ckpt_dir=tmp / where,
                       opt_cfg=OptConfig(**TRAIN["opt"]), save_every=10 ** 9,
                       device=device, mesh=mesh)
        fixed = lp.pipeline.batch_at(0)
        lp.pipeline.batch_at = lambda step: fixed
        lp.save_now = lambda step: None
        lp.init_or_restore()
        return lp, fixed

    out = {}
    if rank == 0:
        lp, _ = loop(None, "plain")
        out["plain_first_loss"] = lp.run(1, log_every=100)[0]
        del lp
        torch.cuda.empty_cache()
    dist.barrier()
    mesh = make_local_mesh(1, n, device=device)
    torch.cuda.reset_peak_memory_stats()
    lp, fixed = loop(mesh, "tp")
    losses = lp.run(1, log_every=100)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += lp.run(TRAIN["steps"], log_every=100)
    torch.cuda.synchronize()
    out["step_s"] = (time.perf_counter() - t0) / (TRAIN["steps"] - 1)
    out["losses"] = losses
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    model, opt = lp.state
    tokens = {"tokens": torch.as_tensor(fixed["tokens"], device=device)}
    by_kernel, busy = profiled(torch, lambda: lp.train_step(model, opt,
                                                            tokens))
    out["busy_share"] = busy
    out["nccl_ms"], out["nccl_launches"] = kernel_total(by_kernel, "nccl")
    return out


def tp_prefill(torch, n: int, device: str, rank: int, reduced: bool) -> dict:
    """Part 3 (module docstring); rank 0 returns the gate's deviations."""
    import torch.distributed as dist

    from chip_smoke import kernel_total, logit_stats, profiled
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import (attention, forward, init_params,
                                    make_batch)
    from repro_torch.models.transformer import param_shapes
    from repro_torch.sharding import place, rules
    from unittest import mock

    cfg = configs.get_config(PREFILL["arch"])
    if reduced:
        cfg = configs.reduced(cfg, dtype="bfloat16", n_layers=5)
    cfg = dataclasses.replace(cfg, attention_impl="pallas")
    seq = 64 if reduced else PREFILL["seq"]
    batch = make_batch(cfg, PREFILL["batch"], seq, seed=0, device=device)

    def model():
        return init_params(cfg, torch.Generator(device).manual_seed(0),
                           device=device)

    out, one = {}, {}
    if rank == 0:
        m = model()
        with torch.no_grad():
            one["reference"] = forward(dataclasses.replace(
                cfg, attention_impl="reference"), m, batch)
            with mock.patch.object(attention, "flash_ops", types.SimpleNamespace(
                    flash_attention=fa_ref.flash_attention)):
                one["floor"] = forward(cfg, m, batch)
            # the model's own bf16 sensitivity, printed beside the gate:
            # its embeddings moved by one bf16 unit roundoff (2^-8)
            noise = torch.randn(m.embed.shape, device=device,
                                generator=torch.Generator(device)
                                .manual_seed(1))
            m.embed.mul_(1 + 2.0 ** -8 * noise)
            one["moved"] = forward(cfg, m, batch)
        del m
        torch.cuda.empty_cache()
    dist.barrier()
    mesh = make_local_mesh(1, n, device=device)
    torch.cuda.reset_peak_memory_stats()
    m = place.distribute_model(model(), rules.param_specs(
        cfg, param_shapes(cfg), mesh, training=False), mesh)
    with torch.no_grad():
        logits = forward(cfg, m, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward(cfg, m, batch, last_only=True)
        torch.cuda.synchronize()
        out["prefill_s"] = time.perf_counter() - t0
        by_kernel, out["busy_share"] = profiled(
            torch, lambda: forward(cfg, m, batch, last_only=True))
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["nccl_ms"], out["nccl_launches"] = kernel_total(by_kernel, "nccl")
    if rank == 0:
        tp_dev = logit_stats(torch, logits, one["reference"])
        floor = logit_stats(torch, one["floor"], one["reference"])
        out["gate"] = {"tp": tp_dev[:2], "floor": floor[:2],
                       "std": floor[3], "mean_ratio": (
                           tp_dev[1] / floor[1] if floor[1] else None)}
        out["embed_ulp_moved"] = logit_stats(torch, one["moved"],
                                             one["reference"])[:2]
    del m, logits, one
    torch.cuda.empty_cache()

    # in f32 at the cut of chip_smoke's phase 15: the placed model's logits
    # against one card's, on the same split-TF32 kernel
    f32 = dataclasses.replace(cfg, dtype="float32", n_layers=min(
        cfg.n_layers, PREFILL["f32_layers"]))
    f32_batch = make_batch(f32, PREFILL["batch"], seq, seed=0, device=device)
    whole = None
    with torch.no_grad():
        if rank == 0:
            m = init_params(f32, torch.Generator(device).manual_seed(0),
                            device=device)
            whole = forward(f32, m, f32_batch)
            del m
        dist.barrier()
        m = place.distribute_model(init_params(
            f32, torch.Generator(device).manual_seed(0), device=device),
            rules.param_specs(f32, param_shapes(f32), mesh, training=False),
            mesh)
        logits = forward(f32, m, f32_batch)
    if rank == 0:
        out["f32_max_abs_diff"] = float((logits - whole).abs().max())
        out["f32_mean_abs_diff"] = float((logits - whole).abs().mean())
    return out


def worker(args) -> int:
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_from_store

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.device == "cpu":
        # the CPU rehearsal: no card to synchronize or to profile
        for name in ("synchronize", "reset_peak_memory_stats",
                     "empty_cache"):
            setattr(torch.cuda, name, lambda *a, **k: None)
        torch.cuda.max_memory_allocated = lambda *a, **k: 0
        import chip_smoke

        chip_smoke.profiled = lambda torch, fn: (fn(), ({}, 0.0))[1]
    tmp = Path(args.tmp)
    init_from_store(dist.FileStore(str(tmp / "store"), args.cards),
                    args.rank, args.cards, device=args.device)
    out = {"backend": dist.get_backend(),
           "cases": tp_cases(torch, args.cards, args.device)}
    out["train"] = train_step(torch, args.cards, args.device, args.rank,
                              args.reduced, tmp)
    out["prefill"] = tp_prefill(torch, args.cards, args.device, args.rank,
                                args.reduced)
    dist.barrier()
    dist.destroy_process_group()
    (tmp / f"rank{args.rank}.json").write_text(json.dumps(out))
    return 0


def check(results: list, gate: bool = True) -> list:
    """The failed checks of part 1, of part 2's first loss (within 1e-2
    relative: bf16 partial sums meet in another order), of part 3's f32
    logits (within 1e-3) and, with ``gate``, of its bf16 gate (the mean
    deviation within 1.1 times the floor's, the largest within 5% of the
    logits' std or 1.5 times the floor's largest; on the CPU the kernel
    is its plain version, so there is no floor to hold it to)."""
    bad = []
    for rank, r in enumerate(results):
        for case, c in r["cases"].items():
            if c["loss_rel"] > 1e-5 or c["grad_rel"] > 1e-4 or not \
                    c["tokens_equal"] or c["logits_diff"] > 1e-4:
                bad.append(f"rank {rank} {case}: {c}")
    t = results[0]["train"]
    rel = abs(t["losses"][0] - t["plain_first_loss"]) / t["plain_first_loss"]
    if rel > 1e-2 or not t["losses"][-1] < t["losses"][0]:
        bad.append(f"train: first loss {t['losses'][0]} against "
                   f"{t['plain_first_loss']}, losses {t['losses']}")
    if results[0]["prefill"]["f32_max_abs_diff"] > 1e-3:
        bad.append(f"prefill: f32 logits differ by "
                   f"{results[0]['prefill']['f32_max_abs_diff']}")
    g = results[0]["prefill"]["gate"]
    if gate and (g["tp"][1] > 1.1 * g["floor"][1] or g["tp"][0] > max(
            0.05 * g["std"], 1.5 * g["floor"][0])):
        bad.append(f"prefill: the bf16 gate failed: {g}")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--reduced", action="store_true",
                    help="stablelm-1.6b at the tests' widths")
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--tmp", default=None)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return worker(args)
    import torch

    if args.device == "cuda" and torch.cuda.device_count() < args.cards:
        print(f"tp_cards: {args.cards} cards needed, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory(prefix="tp_cards_") as tmp:
        env_argv = [sys.executable, __file__, "--cards", str(args.cards),
                    "--device", args.device, "--tmp", tmp] + (
            ["--reduced"] if args.reduced else [])
        procs = [subprocess.Popen(env_argv + ["--rank", str(r)], cwd=REPO)
                 for r in range(args.cards)]
        rcs = []
        for p in procs:
            try:
                rcs.append(p.wait(timeout=1800))
            except subprocess.TimeoutExpired:
                p.kill()
                rcs.append(p.wait())
        if any(rcs):
            print(f"tp_cards: ranks exited {rcs}", file=sys.stderr)
            return 1
        results = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                   for r in range(args.cards)]
    if args.device == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
        print(smi)
    bad = check(results, gate=args.device == "cuda")
    print(json.dumps({"cards": args.cards, "device": args.device,
                      "backend": results[0]["backend"],
                      "cases": results[0]["cases"],
                      "train": [r["train"] for r in results],
                      "prefill": [r["prefill"] for r in results],
                      "failed": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.path[:0] = [str(REPO / "src"), str(REPO)]
    sys.exit(main())
