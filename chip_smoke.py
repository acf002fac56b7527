#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the root of a checkout, on a machine with one NVIDIA H100 and
the CUDA toolkit:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and none is caught:

1. Environment: torch, CUDA, ``nvcc``, the card's name and power limit,
   and the time to build the kernels from ``src/repro_torch``.
2. Kernel parity: both support-join kernels against their plain PyTorch
   versions on edge-case grids, requiring exact equality.
3. Main path: the paper's SEQB two-stage run at its session scale
   (10,000 logged sessions, then 2,000 served) through
   ``PalpatineClient(device="cuda")``.  Mining must launch the frontier
   kernel and never a plain version, and stage 2 must beat the baseline
   client with prefetches.  Both kernels are then checked and timed at
   the shapes this mine gave them.
4. Spill path: the same backlog mined with ``frontier_budget=1`` must
   launch the s-step kernel and give the same patterns, in order.
5. Card against CPU: the same client on ``device="cpu"`` (plain versions)
   must mine the same patterns, in order, and serve stage 2 with the same
   (value, latency) pairs and statistics.
6. One JSON line describing each ported kernel, then the result line.

It imports the port, torch, numpy and the standard library only, and
exits non-zero without a result when CUDA is absent or the port is not
beside it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Iterator, Optional

import numpy as np

REPO = Path(__file__).resolve().parent
KERNEL_SOURCE = "src/repro_torch/kernels/bitmap_support/csrc/bitmap_support.cu"
TPU_KERNELS = "src/repro/kernels/bitmap_support/bitmap_support.py"
DEVICE = "cuda"

#: H100 SXM peaks (NVIDIA's data sheet): HBM bandwidth, and the rate
#: outside the tensor cores, 67 TFLOP/s in float32.  The joins are integer
#: AND/OR/count work with no tensor-core form; the sheet gives no INT32
#: rate, and the float32 one is at least as high, so the bound stays a
#: lower bound on the card's time
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12


# ---------------------------------------------------------------------------
# SEQB, copied from benchmarks/workloads.py (which imports the JAX package)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SEQBConfig:
    n_blocks: int = 100_000
    block_bytes: int = 256
    n_frequent: int = 512          # paper: 80..10,240 frequent sequences
    min_seq: int = 3               # paper: 3..10
    max_seq: int = 10
    zipf_exp: float = 1.0          # paper: 0.5..3.0
    n_sessions: int = 1_500        # per stage (paper: 10,000 total)
    p_pattern: float = 0.85        # read ops following frequent sequences
    write_frac: float = 0.02       # read-intensive
    seed: int = 0


class SEQB:
    def __init__(self, cfg: SEQBConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self.sequences = [
            [int(b) for b in rng.choice(cfg.n_blocks,
                                        size=int(rng.integers(cfg.min_seq,
                                                              cfg.max_seq + 1)),
                                        replace=False)]
            for _ in range(cfg.n_frequent)
        ]
        ranks = np.arange(1, cfg.n_frequent + 1, dtype=np.float64)
        w = ranks ** (-cfg.zipf_exp)
        self.seq_probs = w / w.sum()

    def dataset(self):
        return ((self.key(i), bytes(self.cfg.block_bytes))
                for i in range(self.cfg.n_blocks))

    @staticmethod
    def key(block: int):
        return ("blocks", f"b{block}", "d")

    def sessions(self, rng, n: Optional[int] = None) -> Iterator[list]:
        cfg = self.cfg
        for _ in range(n or cfg.n_sessions):
            if rng.random() < cfg.p_pattern:
                idx = int(rng.choice(len(self.sequences), p=self.seq_probs))
                blocks = self.sequences[idx]
            else:
                # background traffic: log-uniform block popularity
                size = int(rng.integers(cfg.min_seq, cfg.max_seq + 1))
                blocks = [int(cfg.n_blocks ** rng.random()) - 1
                          for _ in range(size)]
                blocks = [b if b >= 0 else 0 for b in blocks]
            yield [self.key(b) for b in blocks]


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """Least time for the work on the card, and what bounds it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn: Callable[[], object], reps: int = 20) -> float:
    """Median CUDA-event time of one call, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profiled(torch, fn: Callable[[], object]) -> None:
    """Run ``fn`` under ``torch.profiler``; print the device's busy time by
    kernel and its share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_kernel: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, n = by_kernel.get(e.name, (0.0, 0))
            by_kernel[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    busy_us = sum(t for t, _ in by_kernel.values())
    print(f"profile: device busy {busy_us / 1e3:.3f} ms of "
          f"{wall_us / 1e3:.3f} ms wall (busy share {busy_us / wall_us:.4f})")
    for name, (t, n) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"  {t / 1e3:10.3f} ms {n:7d}x  {name[:90]}")


def random_words(torch, rng, shape) -> "torch.Tensor":
    w = rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(w).to(DEVICE)


class Parity:
    """Holds each kernel against its plain version on the same inputs."""

    def __init__(self, torch, ops, ref):
        self.torch, self.ops, self.ref = torch, ops, ref
        self.cases = {"frontier_join_support": 0, "sstep_join_support": 0}
        self.max_err = {"frontier_join_support": 0, "sstep_join_support": 0}

    def _diff(self, name: str, got, want, what: str) -> None:
        torch = self.torch
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{name} {what}: {tuple(got.shape)} "
                                 f"{got.dtype} vs {tuple(want.shape)} "
                                 f"{want.dtype}")
        err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        self.max_err[name] = max(self.max_err[name], err)
        if not torch.equal(got, want):
            raise AssertionError(f"{name} {what} differs from the plain "
                                 f"version (max abs err {err})")

    def frontier(self, slots, cand) -> None:
        got = self.ops.frontier_join_support(slots, cand)
        self.torch.cuda.synchronize()
        self._diff("frontier_join_support", got,
                   self.ref.frontier_join_support(slots, cand),
                   f"at {tuple(slots.shape)} x {tuple(cand.shape)}")
        self.cases["frontier_join_support"] += 1

    def sstep(self, slots, cand) -> None:
        joined, sup = self.ops.sstep_join_support(slots, cand)
        self.torch.cuda.synchronize()
        want_joined, want_sup = self.ref.sstep_join_support(slots, cand)
        what = f"at {tuple(slots.shape)} x {tuple(cand.shape)}"
        self._diff("sstep_join_support", joined, want_joined, "joined " + what)
        self._diff("sstep_join_support", sup, want_sup, "support " + what)
        self.cases["sstep_join_support"] += 1


#: (K, S, W) and (P, K, S, W): the grids of tests/test_kernels.py, then
#: ragged 32-tiles, split sessions and sessions wider than one staged chunk
SSTEP_GRID = [(1, 7, 1), (5, 100, 3), (8, 512, 1), (9, 513, 2),
              (32, 1000, 4), (3, 1, 1), (70, 5000, 1), (4, 300, 70)]
FRONTIER_GRID = [(1, 1, 7, 1), (5, 9, 100, 2), (8, 8, 128, 1),
                 (9, 17, 130, 3), (16, 32, 512, 1), (3, 2, 1, 1),
                 (33, 65, 300, 2), (3, 5, 20_000, 1), (4, 33, 50, 70),
                 (40, 40, 3000, 130)]


def edge_parity(torch, parity: Parity) -> None:
    rng = np.random.default_rng(0)
    for k, s, w in SSTEP_GRID:
        parity.sstep(random_words(torch, rng, (s, w)),
                     random_words(torch, rng, (k, s, w)))
    for p, k, s, w in FRONTIER_GRID:
        parity.frontier(random_words(torch, rng, (p, s, w)),
                        random_words(torch, rng, (k, s, w)))
    # sparse words: a candidate bit the slots lack adds no support, and
    # empty P or K returns zeros without a launch
    slots = torch.zeros((2, 64, 2), dtype=torch.int32, device=DEVICE)
    cand = torch.zeros((3, 64, 2), dtype=torch.int32, device=DEVICE)
    cand[1, 3, 0] = 1
    slots[1, 40, 1] = cand[2, 40, 1] = -2 ** 31     # bit 31 only
    parity.frontier(slots, cand)
    parity.sstep(slots[1].contiguous(), cand)
    parity.frontier(slots[:0], cand)
    parity.frontier(slots, cand[:0])
    parity.sstep(slots[0].contiguous(), cand[:0])


def counts_now(ops, ref) -> dict:
    return {"kernel": dict(ops.counts), "plain": dict(ref.counts)}


def reset_counts(ops, ref) -> None:
    for table in (ops.counts, ref.counts):
        for name in table:
            table[name] = 0


def pattern_list(patterns) -> list:
    return [(p.items, p.support) for p in patterns]


def serve_stage2(core, client, sessions) -> list:
    """Stage 2 on fresh statistics: every read's (value, latency)."""
    client.cache.stats = core.CacheStats()
    served = []
    for sess in sessions:
        served.extend(client.read(key) for key in sess)
        client.end_session()
    return served


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sessions", type=int, default=10_000,
                    help="stage-1 sessions logged before mining")
    ap.add_argument("--stage2-sessions", type=int, default=2_000)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch import core
    from repro_torch.kernels import _build
    from repro_torch.kernels.bitmap_support import ops, ref

    # -- phase 1: environment -------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"python {sys.version.split()[0]}")
    print(f"nvcc on PATH: {shutil.which('nvcc') or 'no'}  "
          f"(building with {_build.nvcc_path()})")
    t0 = time.perf_counter()
    ops.load()
    build_s = time.perf_counter() - t0
    built = "bitmap_support" in _build.build_logs
    print(f"kernel build + load: {build_s:.2f} s "
          f"({'built now' if built else 'found already built'} in "
          f"{_build.BUILD_DIR})")
    for line in _build.build_logs.get("bitmap_support", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:", line.strip())

    # -- phase 2: kernel parity on edge grids ---------------------------
    parity = Parity(torch, ops, ref)
    edge_parity(torch, parity)
    print(f"parity: {parity.cases} edge cases exact")

    # -- phase 3: main path ---------------------------------------------
    seqb = SEQB(SEQBConfig(n_sessions=args.sessions, seed=0))
    stage1 = list(seqb.sessions(np.random.default_rng(0), args.sessions))
    stage2 = list(seqb.sessions(np.random.default_rng(1),
                                args.stage2_sessions))

    def make_store():
        store = core.SimulatedDKVStore()
        store.load(seqb.dataset())
        return store

    print(f"store: {seqb.cfg.n_blocks} blocks x {seqb.cfg.block_bytes} B, a "
          "host-side dict (the paper's 2.3M x 1000 B cut 100x, as in "
          "benchmarks/workloads.py); nothing of it on the card")
    # run_two_stage's configuration at the 64 KB cache of the SEQB zipf
    # sweep (benchmarks/bench_seqb.py): the frequent blocks do not all fit,
    # so stage 2 is served by prefetches from the mined trees
    cfg = core.PalpatineConfig(
        heuristic=core.HeuristicConfig("fetch_progressive", top_n=5),
        cache_bytes=64 << 10,
        mining=core.MiningParams(minsup=0.02, min_len=3, max_len=15,
                                 maxgap=1),
        algo="vmsp",
        min_patterns=400,
        dynamic_minsup_floor=0.002,
    )
    client = core.PalpatineClient(make_store(), cfg, device=DEVICE)
    t0 = time.perf_counter()
    for sess in stage1:
        for key in sess:
            client.read(key)
        client.end_session()
    stage1_s = time.perf_counter() - t0

    reset_counts(ops, ref)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_stored = client.mine_now()
    torch.cuda.synchronize()
    mine_s = time.perf_counter() - t0
    main_counts = counts_now(ops, ref)
    print(f"main path counts: {main_counts}")
    if main_counts["kernel"]["frontier_join_support"] == 0:
        raise AssertionError("the main-path mine never launched the "
                             "frontier kernel")
    if any(main_counts["plain"].values()):
        raise AssertionError("the main-path mine ran a plain version")

    # the backlog as mined; stage 2 below logs more sessions into the live one
    db = client.logger.snapshot()
    db = db.tail(len(db))
    dyn = dict(start=cfg.dynamic_minsup_start,
               floor=cfg.dynamic_minsup_floor,
               min_patterns=cfg.min_patterns)

    def direct_mine():
        return core.mine_dynamic_minsup(db, cfg.mining, cfg.algo,
                                        device=DEVICE, **dyn)

    # mined again from scratch, warm: the client's first mine_now above
    # also paid the first use of each CUDA operator
    t0 = time.perf_counter()
    patterns, minsup = direct_mine()
    torch.cuda.synchronize()
    print(f"direct mine of the backlog (bitmaps built anew), warm: "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms wall [{card}]")
    profiled(torch, direct_mine)
    shadow = core.PatternMetastore(cfg.metastore_capacity,
                                   cfg.mining.max_len)
    shadow.populate([p for p in patterns if p.support >= 2])
    if pattern_list(shadow.patterns) != pattern_list(client.metastore.patterns):
        raise AssertionError("the client's metastore differs from a direct "
                             "mine of its backlog")
    vb = client._vb_cache["main"][1]
    k_all, n_sess, n_words = vb.bits.shape
    msc = dataclasses.replace(cfg.mining, minsup=minsup).minsup_count(len(db))
    print(f"mined {len(patterns)} maximal patterns at minsup {minsup} "
          f"(count {msc}); metastore holds {n_stored}")
    print(f"bitmaps on the card: K={k_all} S={n_sess} W={n_words}, "
          f"{vb.bits.numel() * 4} bytes (built at the floor count)")
    print(f"stage 1: {len(stage1)} sessions logged in {stage1_s:.2f} s host; "
          f"mine_now on the card: {mine_s * 1e3:.1f} ms wall [{card}]")

    # the kernels at the shapes this mine gave them: the first frontier
    # level at the minsup used, and the s-step join of its best root
    rows = np.nonzero(vb.freq_support >= msc)[0]
    cand = vb.bits[torch.as_tensor(rows, device=DEVICE)]
    slots = vb.extension_slots(cand, cfg.mining.maxgap).contiguous()
    root = int(np.argmax(vb.freq_support[rows]))
    root_slots = vb.extension_slots(cand[root], cfg.mining.maxgap).contiguous()
    parity.frontier(slots, cand)
    parity.sstep(root_slots, cand)
    p_, k_, s_, w_ = (*slots.shape[:1], *cand.shape)
    # bounds: each input read once, each output written once; the frontier
    # join needs one AND per (nonzero slot word, candidate) of this data,
    # though the dense kernel does all P*K*S*W (its bound: dense_bound_ms)
    nnz = int((slots != 0).sum())
    f_bound, f_by = bound_ms((p_ + k_) * s_ * w_ * 4 + p_ * k_ * 4, nnz * k_)
    f_dense, _ = bound_ms(0, p_ * k_ * s_ * w_)
    s_bound, s_by = bound_ms(2 * k_ * s_ * w_ * 4 + s_ * w_ * 4 + k_ * 4,
                             k_ * s_ * w_)
    timing = {
        "frontier_join_support": dict(
            ms=time_ms(torch, lambda: ops.frontier_join_support(slots, cand)),
            plain_ms=time_ms(torch, lambda: ref.frontier_join_support(
                slots, cand), reps=5),
            bound_ms=f_bound, bound_by=f_by, dense_bound_ms=f_dense,
            shape=[p_, k_, s_, w_], nonzero_slot_words=nnz),
        "sstep_join_support": dict(
            ms=time_ms(torch, lambda: ops.sstep_join_support(root_slots, cand)),
            plain_ms=time_ms(torch, lambda: ref.sstep_join_support(
                root_slots, cand)),
            bound_ms=s_bound, bound_by=s_by, shape=[k_, s_, w_]),
    }
    for name, t in timing.items():
        print(f"{name} at {t['shape']}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}) [{card}]")

    t_virtual = client.clock.now
    served = serve_stage2(core, client, stage2)
    lats = [lat for _, lat in served]
    base = core.BaselineClient(make_store())
    base_lats = [base.read(key)[1] for sess in stage2 for key in sess]
    st = client.stats
    mean_us, base_us = np.mean(lats) * 1e6, np.mean(base_lats) * 1e6
    if not (np.isfinite(mean_us) and mean_us < base_us):
        raise AssertionError(f"stage-2 mean latency {mean_us} us does not "
                             f"beat the baseline's {base_us} us")
    if st.prefetch_hits == 0:
        raise AssertionError("stage 2 was served by no prefetch")
    print(f"stage 2: {len(stage2)} sessions, {len(lats)} reads, hit rate "
          f"{st.hit_rate:.4f}, precision {st.precision:.4f}, prefetches "
          f"{st.prefetches}; mean latency {mean_us:.2f} us vs baseline "
          f"{base_us:.2f} us (virtual-clock, not card time; "
          f"{(client.clock.now - t_virtual):.3f} virtual s)")

    # -- phase 4: spill path --------------------------------------------
    reset_counts(ops, ref)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spilled, spill_minsup = core.mine_dynamic_minsup(
        db, dataclasses.replace(cfg.mining, frontier_budget=1), cfg.algo,
        device=DEVICE, **dyn)
    torch.cuda.synchronize()
    spill_s = time.perf_counter() - t0
    spill_counts = counts_now(ops, ref)
    print(f"spill path counts: {spill_counts}; {spill_s * 1e3:.1f} ms wall "
          f"[{card}]")
    if spill_counts["kernel"]["sstep_join_support"] == 0:
        raise AssertionError("the spill mine never launched the s-step kernel")
    if any(spill_counts["plain"].values()):
        raise AssertionError("the spill mine ran a plain version")
    if (pattern_list(spilled), spill_minsup) != (pattern_list(patterns), minsup):
        raise AssertionError("the spill path mined other patterns")

    # -- phase 5: card against CPU --------------------------------------
    # the same client on the CPU (plain versions), same store and traffic:
    # its mine and every stage-2 (value, latency) must equal the card's
    cpu_client = core.PalpatineClient(make_store(), cfg, device="cpu")
    for sess in stage1:
        for key in sess:
            cpu_client.read(key)
        cpu_client.end_session()
    reset_counts(ops, ref)
    t0 = time.perf_counter()
    cpu_client.mine_now()
    cpu_s = time.perf_counter() - t0
    if ref.counts["frontier_join_support"] == 0 or any(ops.counts.values()):
        raise AssertionError(f"the CPU mine did not run on the plain "
                             f"versions: {counts_now(ops, ref)}")
    if (pattern_list(cpu_client.metastore.patterns)
            != pattern_list(client.metastore.patterns)):
        raise AssertionError("the CPU client mined other patterns")
    if serve_stage2(core, cpu_client, stage2) != served:
        raise AssertionError("stage 2 on the CPU client served other "
                             "(value, latency) pairs")
    if cpu_client.stats != st or cpu_client.clock.now != client.clock.now:
        raise AssertionError("stage-2 cache statistics or virtual clocks "
                             "differ between the CPU and card clients")
    print(f"CPU client (plain versions): same {len(cpu_client.metastore)} "
          f"patterns, same {len(served)} stage-2 (value, latency) pairs and "
          f"statistics; its mine_now took {cpu_s:.2f} s host wall")

    # -- phase 6: the kernels line and the result -------------------------
    launches = {"frontier_join_support": ("main", main_counts),
                "sstep_join_support": ("spill", spill_counts)}
    replaces = {"frontier_join_support": f"{TPU_KERNELS}:135",
                "sstep_join_support": f"{TPU_KERNELS}:73"}
    kernels = []
    for name in ("frontier_join_support", "sstep_join_support"):
        path, counted = launches[name]
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": replaces[name],
            "launches": counted["kernel"][name], "path": path,
            "parity_cases": parity.cases[name],
            "max_abs_err": parity.max_err[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "shape": t["shape"],
            **({"dense_bound_ms": t["dense_bound_ms"],
                "nonzero_slot_words": t["nonzero_slot_words"]}
               if "dense_bound_ms" in t else {}),
        })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
