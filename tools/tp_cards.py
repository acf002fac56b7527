"""Tensor parallelism across the cards of one host, on NCCL.

    python3 tools/tp_cards.py [--cards 4]
    python3 tools/tp_cards.py --device cpu --reduced   # 4 gloo ranks

Starts one process a card (a ``FileStore`` in a temporary directory, no
port), each running the port's tensor-parallel paths on a mesh of all
the cards:

1. the tensor-parallel cases of ``tests/test_torch_distributed.py`` at
   (1, n) and (2, n / 2), with and without sequence parallelism, in f32
   with TF32 off (reduced dense, GQA with 2 key/value heads, vlm, and
   moe with 3 experts): the loss within 1e-5 relative and every gradient
   within 1e-4 of its tensor's max-abs of the same weights unplaced on
   the same card, and the placed model's greedy ``prefill`` and 4
   ``decode_step``s (its cache placed by ``rules.cache_pspec``) giving
   the unplaced model's tokens, its logits within 1e-4;
2. stablelm-1.6b at full width and depth (bf16, ``remat="full"``, batch
   4 x 2,048 on one fixed batch, ``"reference"`` attention) through
   ``TrainLoop(mesh=)`` at (1, n): the first loss against the unsharded
   loop's on one card (rank 0, before), then a warm step's seconds,
   peak memory, and one profiled step's busy share and NCCL kernel time.

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
}
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
    dist.barrier()
    dist.destroy_process_group()
    (tmp / f"rank{args.rank}.json").write_text(json.dumps(out))
    return 0


def check(results: list) -> list:
    """The failed checks of part 1, and of part 2's first loss (within
    1e-2 relative: bf16 partial sums meet in another order)."""
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
    bad = check(results)
    print(json.dumps({"cards": args.cards, "device": args.device,
                      "backend": results[0]["backend"],
                      "cases": results[0]["cases"],
                      "train": [r["train"] for r in results],
                      "failed": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.path[:0] = [str(REPO / "src"), str(REPO)]
    sys.exit(main())
