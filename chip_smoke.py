#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the root of a checkout, on a machine with one NVIDIA H100 and
the CUDA toolkit:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and none is caught:

1. Environment: torch, CUDA, ``nvcc``, the card's name and power limit,
   and the time to build the kernels from ``src/repro_torch`` (one
   ``nvcc`` per source, started together), with ``ptxas``'s registers,
   shared memory and spills; the count of ``HGMMA`` (warpgroup
   tensor-core) instructions in the bf16 flash kernel's SASS and of
   ``HMMA`` (``mma.sync``) instructions in the split-TF32 one, by
   ``cuobjdump -sass``, each of which must be above 0.
2. Kernel parity: both support-join kernels against their plain PyTorch
   versions on edge-case grids, requiring exact equality (the s-step
   kernel also on slots nonzero in 0.4%, 1% and 12.6% of the sessions,
   the densities of the SEQB spill walk; the frontier
   kernel also on the sparse grid of ``frontier_cases``: 0, 1, 10 and 100%
   of (prefix, session) pairs nonzero, one prefix in every session among
   empty ones, only the last of W > 1 words set, bit 31 only); both
   flash-attention kernels (the tensor-core route, bf16 at head_dim 64
   and 128, and the split-TF32 route, f32 and every other bf16 head_dim)
   against their plain version on the grids of ``tests/test_kernels.py``
   and more, with the tensor-core kernel's edges (ragged 1,000, Lq > Lk,
   Lq < Lk = 513, GQA 56/8, MQA) and the split-TF32 kernel's head_dims
   40, 48, 72, 80, 96 and 112 (zamba2-7b's; 40 and 72 zero-padded), f32
   within 2e-5 with TF32 off and bf16 within 2e-2.
3. Main path: the paper's SEQB two-stage run at its session scale
   (10,000 logged sessions, then 2,000 served) through
   ``PalpatineClient(device="cuda")``.  Mining must launch the frontier
   kernel and never a plain version, and stage 2 must beat the baseline
   client with prefetches.  Both kernels are then checked and timed at
   the shapes this mine gave them, the frontier kernel also on random
   words at the same shape (every pair nonzero), with its device time and
   device operations per call from ``torch.profiler``; the s-step kernel
   at the densest DFS node (the best root) and a median one, with its
   device time and both of its bounds (this data's and the dense one).
4. Spill path: the same backlog mined with ``frontier_budget=1`` must
   launch the s-step kernel and give the same patterns, in order; its
   profile gives the s-step kernels' device total and the busy share.
5. Card against CPU: the same client on ``device="cpu"`` (plain versions)
   must mine the same patterns, in order, and serve stage 2 with the same
   (value, latency) pairs and statistics.
6. Serving path: codeqwen1.5-7b at full width and depth, bf16, random
   weights from seed 0 made on the card, ``attention_impl="pallas"``,
   through ``ServingEngine``: 3 requests of batch 4 x prompt 2,048 x 32
   greedy tokens.  Every prefill layer must launch the tensor-core flash
   kernel (32 x 3), never the split-TF32 one and never the plain version.
   One prefill and one decode step are profiled.
7. Serving against the plain path: the first request's bf16 prefill
   logits against ``attention_impl="reference"``, within 5% of their
   standard deviation or within bf16's own floor, measured by running
   the kernel's plain version in its place; at full width cut to 2
   layers in f32 (the split-TF32 route), all 4 x 32 greedy tokens equal
   between kernel and plain paths.
8. Timing of each flash kernel, its plain version and PyTorch's
   ``scaled_dot_product_attention`` (the yardstick; never on the path)
   at the prefill shape, beside the card's bound: the tensor-core kernel
   in bf16, the split-TF32 kernel in f32 (bound: three TF32 products a
   product at 495 TFLOP/s, with the f32 FMA bound beside it), and the
   split-TF32 kernel in f32 at head_dim 112.
9. Decision walk: the ``"torch"`` decision engine on the card in lockstep
   with the numpy engine over the SEQB client's index and the stage-2
   requests, for each heuristic (equal waves at every op); the per-op
   cost of both at 1, 16 and 64 live contexts on ``bench_overhead``'s
   chain forest.
10. Cluster: ``bench_cluster``'s largest static configuration (8 shards,
   16 tenants, 250 TPC-C transactions a tenant a stage), every tenant
   mining on the card (each tenant's mine launches the frontier kernel,
   never a plain version), mean read latency below the baseline's, and
   latencies, statistics and exchanged patterns equal to the same run on
   the CPU; one profile of a tenant's warm ``mine_now``.
11. Expert prefetcher: ``bench_serving``'s full closed loop (4 shards,
   500 requests) for each traffic shape, one ``ExpertPrefetcher`` a
   tenant mining on the card (frontier kernel only, ``ExpertStore``
   decoding to CUDA tensors), its statistics equal to the same loop on
   the CPU; one profile of a prefetcher's warm ``mine_now``.
12. One JSON line describing each ported kernel, then the result line.

It imports the port, torch, numpy and the standard library only, and
exits non-zero without a result when CUDA is absent or the port is not
beside it.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path
from typing import Callable, Iterator, Optional

import numpy as np

REPO = Path(__file__).resolve().parent
KERNEL_SOURCE = "src/repro_torch/kernels/bitmap_support/csrc/bitmap_support.cu"
TPU_KERNELS = "src/repro/kernels/bitmap_support/bitmap_support.py"
#: route of ops.route -> (its kernel's name in the kernels line, source)
FLASH_KERNELS = {
    "tensor_core": ("flash_attention", "src/repro_torch/kernels/"
                    "flash_attention/csrc/flash_attention_wgmma.cu"),
    "tf32x3": ("flash_attention_tf32x3", "src/repro_torch/kernels/"
               "flash_attention/csrc/flash_attention_tf32x3.cu"),
}
FLASH_TPU_KERNEL = "src/repro/kernels/flash_attention/flash_attention.py:112"
DEVICE = "cuda"

#: the serving run: codeqwen1.5-7b (the default architecture of the
#: repo's serving entry points) at full width and depth, 3 requests of
#: batch 4 x prompt 2,048 x 32 new tokens
SERVE_ARCH = "codeqwen1.5-7b"
SERVE_REQUESTS = 3
SERVE_BATCH = 4
SERVE_PROMPT = 2048
SERVE_NEW = 32
#: the f32 check of greedy tokens, at full width cut to this depth
F32_LAYERS = 2

#: H100 SXM peaks (NVIDIA's data sheet): HBM bandwidth, and the rate
#: outside the tensor cores, 67 TFLOP/s in float32.  The joins are integer
#: AND/OR/count work with no tensor-core form; the sheet gives no INT32
#: rate, and the float32 one is at least as high, so the bound stays a
#: lower bound on the card's time
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
#: dense bf16 tensor-core rate (NVIDIA's data sheet): the bound of
#: attention on bf16 inputs
PEAK_BF16_FLOP_PER_S = 989e12
#: dense TF32 tensor-core rate (the same sheet); split TF32 runs three
#: TF32 products for each f32 one
PEAK_TF32_FLOP_PER_S = 495e12
TF32_SPLIT_PRODUCTS = 3


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
# TPC-C, the cluster sweep, the serving loop and the decision benchmark's
# forest, copied from benchmarks/{workloads,bench_cluster,bench_serving,
# bench_overhead}.py (which import the JAX package).  The functions take
# the package they run on (``core``, ``serving``), so the tests run them
# on both packages.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TPCCConfig:
    warehouses: int = 1
    districts: int = 10            # paper scale
    customers_per_district: int = 300   # paper: 3000 (scaled 10x)
    items: int = 10_000            # paper: 100,000 (scaled 10x)
    orders_per_district: int = 90  # paper: 900 (scaled 10x)
    value_bytes: int = 200         # paper: blocks of <= 500 bytes
    n_transactions: int = 350      # paper: 350 second-stage transactions
    seed: int = 0


class TPCC:
    """Transactions become container-access sessions; the standard mix is
    new-order 45%, payment 43%, order-status 4%, delivery 4%, stock-level 4%.
    """

    MIX = (("new_order", 0.45), ("payment", 0.43), ("order_status", 0.04),
           ("delivery", 0.04), ("stock_level", 0.04))

    def __init__(self, cfg: TPCCConfig):
        self.cfg = cfg

    @staticmethod
    def k_warehouse(w):
        return ("warehouse", f"w{w}", "info")

    @staticmethod
    def k_district(w, d):
        return ("district", f"w{w}d{d}", "info")

    @staticmethod
    def k_customer(w, d, c):
        return ("customer", f"w{w}d{d}c{c}", "info")

    @staticmethod
    def k_item(i):
        return ("item", f"i{i}", "info")

    @staticmethod
    def k_stock(w, i):
        return ("stock", f"w{w}i{i}", "qty")

    @staticmethod
    def k_order(w, d, o):
        return ("orders", f"w{w}d{d}o{o}", "info")

    @staticmethod
    def k_order_line(w, d, o, l):
        return ("order_line", f"w{w}d{d}o{o}", f"l{l}")

    def dataset(self) -> list:
        cfg = self.cfg
        val = bytes(cfg.value_bytes)
        items = []
        for w in range(cfg.warehouses):
            items.append((self.k_warehouse(w), val))
            for d in range(cfg.districts):
                items.append((self.k_district(w, d), val))
                for c in range(cfg.customers_per_district):
                    items.append((self.k_customer(w, d, c), val))
                for o in range(cfg.orders_per_district):
                    items.append((self.k_order(w, d, o), val))
                    for l in range(3):
                        items.append((self.k_order_line(w, d, o, l), val))
        for i in range(cfg.items):
            items.append((self.k_item(i), val))
            for w in range(cfg.warehouses):
                items.append((self.k_stock(w, i), val))
        return items

    def transaction(self, rng) -> list:
        cfg = self.cfg
        r = rng.random()
        acc = 0.0
        kind = self.MIX[-1][0]
        for name, p in self.MIX:
            acc += p
            if r < acc:
                kind = name
                break
        w = int(rng.integers(0, cfg.warehouses))
        d = int(rng.integers(0, cfg.districts))
        c = self._nurand(rng, cfg.customers_per_district)
        ops: list = [("r", self.k_warehouse(w)), ("r", self.k_district(w, d))]
        if kind == "new_order":
            ops.append(("r", self.k_customer(w, d, c)))
            o = int(rng.integers(0, cfg.orders_per_district))
            ops.append(("w", self.k_order(w, d, o)))
            for l in range(int(rng.integers(2, 5))):
                i = self._nurand(rng, cfg.items)
                ops += [("r", self.k_item(i)), ("r", self.k_stock(w, i)),
                        ("w", self.k_stock(w, i)),
                        ("w", self.k_order_line(w, d, o, l))]
        elif kind == "payment":
            ops += [("w", self.k_warehouse(w)), ("w", self.k_district(w, d)),
                    ("r", self.k_customer(w, d, c)),
                    ("w", self.k_customer(w, d, c))]
        elif kind == "order_status":
            o = int(rng.integers(0, cfg.orders_per_district))
            ops += [("r", self.k_customer(w, d, c)),
                    ("r", self.k_order(w, d, o))]
            ops += [("r", self.k_order_line(w, d, o, l)) for l in range(3)]
        elif kind == "delivery":
            for o in rng.integers(0, cfg.orders_per_district, size=3):
                ops += [("r", self.k_order(w, d, int(o))),
                        ("w", self.k_order(w, d, int(o)))]
        else:  # stock_level
            for i in rng.integers(0, cfg.items, size=6):
                ops.append(("r", self.k_stock(w, int(i))))
        return ops

    @staticmethod
    def _nurand(rng, n: int) -> int:
        """Non-uniform access (TPC-C NURand flavour): 30% of keys get 70%
        of accesses."""
        if rng.random() < 0.7:
            return int(rng.integers(0, max(1, int(n * 0.3))))
        return int(rng.integers(0, n))


def tenant_streams(gen: TPCC, n_clients: int, n_tx: int, seed: int):
    """One independent transaction stream per tenant (distinct rng)."""
    out = []
    for t in range(n_clients):
        rng = np.random.default_rng(seed * 1000 + t)
        out.append([gen.transaction(rng) for _ in range(n_tx)])
    return out


def cluster_config(core):
    """``bench_cluster.palpatine_config()``: the bench_tpcc working point,
    per tenant."""
    return core.PalpatineConfig(
        heuristic=core.HeuristicConfig("fetch_progressive"),
        cache_bytes=1 << 20,
        mining=core.MiningParams(minsup=0.02, min_len=3, max_len=15,
                                 maxgap=1),
        min_patterns=400,
        dynamic_minsup_floor=0.002,
        column_mining=True,
    )


def loadgen_config(serving, shape: str, quick: bool, seed: int):
    """``bench_serving.loadgen_config``."""
    return serving.LoadgenConfig(
        n_tenants=3, n_domains=6,
        n_layers=6, n_experts=32,
        zipf_s=1.3, path_noise=0.1,
        session_churn=0.5,
        kv_seqs=48 if quick else 96, kv_blocks=2, kv_block_bytes=1024,
        decode_steps=1,
        requests=150 if quick else 500,
        base_rate=400.0,
        shape=shape, seed=seed)


def prefetcher_config(core, serving):
    """``bench_serving.palpatine_config(prefetch=True)`` as the expert
    prefetcher's configuration: 16 expert slots, half of them preemptive,
    minsup 0.05 on lengths 3-15 with maxgap 1, at least 16 patterns."""
    return serving.PrefetcherConfig(
        heuristic=core.HeuristicConfig("fetch_progressive"),
        cache_experts=16, preemptive_frac=0.5,
        mining=core.MiningParams(minsup=0.05, min_len=3, max_len=15,
                                 maxgap=1),
        min_patterns=16)


def closed_loop(clients, streams) -> list:
    """Each client's session stream, always stepping the client whose
    virtual clock is furthest behind, one session at a time: ``("mr",
    keys)`` through ``read_many``, ``("r", key)`` through ``read``, then
    ``end_session``.  Returns each client's read latencies."""
    import heapq

    lats = [[] for _ in clients]
    pos = [0] * len(clients)
    heap = [(c.clock.now, i) for i, c in enumerate(clients) if streams[i]]
    heapq.heapify(heap)
    while heap:
        _, i = heapq.heappop(heap)
        c = clients[i]
        for op in streams[i][pos[i]]:
            if op[0] == "mr":
                lats[i].append(c.read_many(op[1])[1])
            else:
                lats[i].append(c.read(op[1])[1])
        c.end_session()
        pos[i] += 1
        if pos[i] < len(streams[i]):
            heapq.heappush(heap, (c.clock.now, i))
    return lats


def prefetcher_loop(core, serving, shape: str, quick: bool, seed: int,
                    **dev) -> dict:
    """``bench_serving``'s closed loop served by one ``ExpertPrefetcher``
    a tenant over one cluster-resident ``ExpertStore`` (2 shards quick, 4
    full) and one ``PatternExchange``: a warm stream of another seed, a
    mine of every prefetcher (publish and pull), then the measured
    stream.  Each prefetcher also mines every 64 sessions it ends.
    ``dev`` is ``{"device": ...}`` for the port, empty for the
    reference."""
    gen = serving.LoadGenerator(loadgen_config(serving, shape, quick, seed))
    cfg = gen.cfg
    store = serving.ExpertStore(cfg.n_layers, cfg.n_experts, d=16, f=16,
                                dkv=core.ShardedDKVStore(2 if quick else 4),
                                **dev)
    store.dkv.load(gen.dataset())
    exchange = core.PatternExchange()
    pcfg = prefetcher_config(core, serving)
    pfs = [serving.ExpertPrefetcher(store, pcfg, exchange=exchange, **dev)
           for _ in range(cfg.n_tenants)]
    warm = serving.LoadGenerator(dataclasses.replace(cfg, seed=cfg.seed + 100))
    closed_loop(pfs, warm.streams())
    mined = [pf.mine_now() for pf in pfs]
    for pf in pfs:
        pf.cache.stats = core.CacheStats()
        pf.cache.reset_attr()
    lats = closed_loop(pfs, gen.streams())
    return {"lats": lats, "mined": mined,
            "stats": [pf.stats for pf in pfs],
            "exchanged": [(p.items, p.support) for p in exchange.store],
            "store": store, "prefetchers": pfs}


def chain_forest(core, window: int, length: int, fanout: int = 4):
    """``bench_overhead.chain_forest``: a forest that holds exactly
    ``window`` live contexts in steady state (item ``i`` roots a tree over
    the chain ``i..i+window``), each chain node with ``fanout`` decoy
    children, so waves have width."""
    pats = []
    decoy = length
    for i in range(length - window):
        chain = tuple(range(i, i + window + 1))
        pats.append(core.Pattern(chain, 64))
        for d in range(1, window + 1):
            for f in range(fanout):
                pats.append(core.Pattern(chain[:d] + (decoy,), 1))
                decoy += 1
    return core.PTreeIndex.build(pats)


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = PEAK_OPS_PER_S) -> tuple[float, str]:
    """Least time for the work on the card, and what bounds it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
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


def profiled(torch, fn: Callable[[], object]) -> tuple[dict, float]:
    """Run ``fn`` under ``torch.profiler``; print the device's busy time by
    kernel and its share of the wall time, and return the busy time by
    kernel name (us, launches) and the busy share."""
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
    return by_kernel, busy_us / wall_us


def kernel_total(by_kernel: dict, name: str) -> tuple[float, int]:
    """Device ms and launches of the kernels whose name holds ``name``."""
    hits = [v for k, v in by_kernel.items() if name in k]
    return sum(t for t, _ in hits) / 1e3, sum(n for _, n in hits)


def device_work(torch, fn: Callable[[], object], reps: int = 10) -> dict:
    """Under ``torch.profiler``, over ``reps`` calls of ``fn``: the device
    operations (kernels, memsets, copies) of one call and the device time
    of one call, in all and by operation name (ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    n_ops = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / reps / 1e3)
            n_ops += 1
    return {"ops": n_ops / reps, "ms": sum(by_name.values()),
            "by_name": by_name}


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

    def frontier(self, slots, cand, what: str = "") -> None:
        """As the miner calls it (with the walk's session-major copy of
        ``cand``) and without that copy (the wrapper makes its own)."""
        want = self.ref.frontier_join_support(slots, cand)
        what = f"{what} at {tuple(slots.shape)} x {tuple(cand.shape)}"
        for cand_t in (self.ops.session_major(cand), None):
            got = self.ops.frontier_join_support(slots, cand, cand_t)
            self.torch.cuda.synchronize()
            self._diff("frontier_join_support", got, want, what)
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
#: ragged 8-prefix tiles, several 256-session ranges and W up to 130
SSTEP_GRID = [(1, 7, 1), (5, 100, 3), (8, 512, 1), (9, 513, 2),
              (32, 1000, 4), (3, 1, 1), (70, 5000, 1), (4, 300, 70)]
FRONTIER_GRID = [(1, 1, 7, 1), (5, 9, 100, 2), (8, 8, 128, 1),
                 (9, 17, 130, 3), (16, 32, 512, 1), (3, 2, 1, 1),
                 (33, 65, 300, 2), (3, 5, 20_000, 1), (4, 33, 50, 70),
                 (40, 40, 3000, 130)]


#: (P, K, S, W, density): the share of (prefix, session) pairs with a
#: nonzero slot word, from none through the miner's ~1% to every pair; the
#: frontier kernel's edges: K past 256, 512 and 1,024 candidates (1, 2 and
#: 4 a thread, then two chunks), S within one 256-session range and past
#: it, ragged 8-prefix tiles, and W > 1
FRONTIER_DENSITY_GRID = [(20, 300, 700, 1, d) for d in (0.0, 0.01, 0.1, 1.0)] \
    + [(9, 1100, 300, 1, 0.1), (5, 40, 200, 1, 0.1), (12, 70, 513, 3, 0.01),
       (12, 70, 513, 3, 1.0)]


def frontier_cases(rng) -> list:
    """The sparse grid: (name, slots, cand), uint32 numpy words.  The
    candidates are nonzero in 20% of their sessions."""
    def words(shape, density):
        w = rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)
        return w * (rng.random(shape[:2]) < density)[..., None]

    cases = [(f"{d:.0%} of pairs nonzero, P={p} K={k} S={s} W={w}",
              words((p, s, w), d), words((k, s, w), 0.2))
             for p, k, s, w, d in FRONTIER_DENSITY_GRID]
    slots = np.zeros((17, 600, 1), np.uint32)
    slots[9] = words((1, 600, 1), 1.0) | 1
    cases.append(("one prefix in every session among empty ones", slots,
                   words((700, 600, 1), 0.2)))
    slots = words((6, 400, 4), 0.5)
    slots[..., :-1] = 0
    cases.append(("only the last of 4 words set", slots,
                  words((50, 400, 4), 0.5)))
    bit31 = np.uint32(1 << 31)
    cases.append(("bit 31 only",
                  (rng.random((11, 300, 2)) < 0.3).astype(np.uint32) * bit31,
                  (rng.random((33, 300, 2)) < 0.5).astype(np.uint32) * bit31))
    return cases


#: (K, S, W, density): the s-step kernel's sparse grid, slot rows nonzero
#: in this share of the sessions: the SEQB spill walk's median node
#: (0.4%), 1%, its densest node (12.6%) and every session; 4 one-word
#: sessions a thread (S % 4 == 0) or one (S % 4 != 0), W > 1, one
#: session range and many, K past one block's 32 candidates
SSTEP_DENSITY_GRID = [(467, 10_000, 1, 0.004), (300, 2_000, 1, 0.01),
                      (467, 10_000, 1, 0.126), (70, 4_099, 1, 0.126),
                      (33, 1_000, 3, 0.01), (40, 700, 2, 0.126),
                      (5, 12, 1, 1.0), (100, 5_001, 1, 1.0)]


def sstep_cases(rng) -> list:
    """The s-step kernel's sparse grid: (name, slots, cand), uint32 numpy
    words, the slot words random and nonzero in ``density`` of the
    sessions, the candidates random."""
    cases = []
    for k, s, w, d in SSTEP_DENSITY_GRID:
        slots = rng.integers(1, 2 ** 32, size=(s, w), dtype=np.uint32)
        slots *= (rng.random((s, 1)) < d).astype(np.uint32)
        cand = rng.integers(0, 2 ** 32, size=(k, s, w), dtype=np.uint32)
        cases.append((f"{d:.1%} of sessions nonzero, K={k} S={s} W={w}",
                      slots, cand))
    return cases


def edge_parity(torch, parity: Parity) -> None:
    rng = np.random.default_rng(0)
    for k, s, w in SSTEP_GRID:
        parity.sstep(random_words(torch, rng, (s, w)),
                     random_words(torch, rng, (k, s, w)))
    for p, k, s, w in FRONTIER_GRID:
        parity.frontier(random_words(torch, rng, (p, s, w)),
                        random_words(torch, rng, (k, s, w)))
    for _, slots, cand in sstep_cases(np.random.default_rng(4)):
        parity.sstep(*(torch.from_numpy(x.view(np.int32)).to(DEVICE)
                       for x in (slots, cand)))
    for name, slots, cand in frontier_cases(np.random.default_rng(3)):
        parity.frontier(*(torch.from_numpy(x.view(np.int32)).to(DEVICE)
                          for x in (slots, cand)), name)
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


#: (b, hq, hkv, lq, lk, d): tests/test_kernels.py's flash grid (MHA,
#: GQA 2, MQA, ragged 96 and 130, D 32/64/128), then decode-aligned
#: Lq < Lk, Lq > Lk (causal: fully masked rows give 0), GQA group 7
#: (yi-34b's 56/8), head_dim 16 and a one-row query
FLASH_GRID = [(1, 2, 2, 128, 128, 64), (2, 4, 2, 128, 128, 64),
              (1, 8, 1, 256, 256, 32), (1, 2, 2, 96, 96, 64),
              (1, 4, 4, 130, 130, 128), (1, 2, 2, 8, 192, 64),
              (1, 2, 1, 100, 40, 32), (1, 14, 2, 80, 80, 16),
              (2, 56, 8, 65, 65, 128), (3, 4, 4, 1, 300, 128)]
#: bf16 only, the tensor-core kernel's 128-row tiles at their edges:
#: ragged Lq = Lk = 1,000; Lq > Lk (rows with no visible column, a whole
#: q tile of them); Lq < Lk = 4 x 128 + 1; GQA 56/8 at D 128 over several
#: tiles; MQA at D 64; B * Hq = 65,664, past a grid's y limit of 65,535,
#: two q tiles each
FLASH_TC_EDGES = [(1, 4, 2, 1000, 1000, 128), (1, 4, 2, 300, 100, 128),
                  (1, 2, 2, 200, 513, 128), (1, 56, 8, 300, 300, 128),
                  (2, 8, 1, 300, 300, 64), (513, 128, 8, 129, 129, 64)]
#: the split-TF32 kernel at every head_dim it was not instantiated for
#: before: 48, 80, 96 and 112 (zamba2-7b's) by their own instantiations,
#: 40 and 72 zero-padded to 48 and 80; ragged 130, Lq < Lk, and GQA 8/2
#: at 112
FLASH_ANY_D = [(1, 2, 2, 130, 130, d) for d in (40, 48, 72, 80, 96, 112)] \
    + [(1, 2, 2, 70, 200, 112), (2, 8, 2, 100, 100, 112)]
#: f32 with TF32 off: both sides are true f32 and differ in summation
#: order only; bf16: one rounding of the output
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


class FlashParity:
    """Holds each flash kernel against the plain version on the same
    inputs: |kernel - plain| <= tol + tol * |plain|, elementwise.  Cases
    and errors are kept by route and by dtype."""

    def __init__(self, torch, ops, ref):
        self.torch, self.ops, self.ref = torch, ops, ref
        self.cases = {r: 0 for r in ops.ROUTES}
        self.max_err = {(r, t): 0.0 for r in ops.ROUTES
                        for t in ("float32", "bfloat16")}

    def check(self, q, k, v, causal: bool) -> None:
        torch = self.torch
        which = self.ops.route(q.dtype, q.shape[-1])
        before = self.ops.counts[which]
        got = self.ops.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        if self.ops.counts[which] != before + 1:
            raise AssertionError(f"flash_attention did not launch its "
                                 f"{which} kernel")
        want = self.ref.flash_attention(q, k, v, causal=causal)
        name = str(q.dtype).split(".")[-1]
        what = (f"flash_attention ({which}) {name} causal={causal} q "
                f"{tuple(q.shape)} kv {tuple(k.shape)}")
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{what}: {tuple(got.shape)} {got.dtype} "
                                 f"vs {tuple(want.shape)} {want.dtype}")
        diff = (got.float() - want.float()).abs()
        err = float(diff.max()) if diff.numel() else 0.0
        self.max_err[which, name] = max(self.max_err[which, name], err)
        tol = FLASH_TOL[name]
        if not bool(torch.isfinite(got).all()) or bool(
                (diff > tol + tol * want.float().abs()).any()):
            raise AssertionError(f"{what} differs from the plain version "
                                 f"(max abs err {err}, tol {tol})")
        self.cases[which] += 1

    def max_abs_err(self, which: str) -> float:
        return max(e for (r, _), e in self.max_err.items() if r == which)

    def summary(self) -> str:
        return "; ".join(
            f"{r}: {self.cases[r]} cases, max abs err " + ", ".join(
                f"{t} {self.max_err[r, t]:.3e}" for t in ("float32", "bfloat16"))
            for r in self.cases)


def random_qkv(torch, rng, b, hq, hkv, lq, lk, d, dtype):
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .to(DEVICE, dtype)
                 for s in ((b, hq, lq, d), (b, hkv, lk, d), (b, hkv, lk, d)))


def flash_edge_parity(torch, parity: FlashParity) -> None:
    rng = np.random.default_rng(0)
    for shape in FLASH_GRID:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = random_qkv(torch, rng, *shape, dtype)
            for causal in (True, False):
                parity.check(q, k, v, causal)
    for shape in FLASH_TC_EDGES:
        q, k, v = random_qkv(torch, rng, *shape, torch.bfloat16)
        for causal in (True, False):
            parity.check(q, k, v, causal)
    for shape in FLASH_ANY_D:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = random_qkv(torch, rng, *shape, dtype)
            for causal in (True, False):
                parity.check(q, k, v, causal)
    # the model's layout: (B, S, H, D) activations viewed as (B, H, S, D),
    # on each route (the tensor-core kernel reads them through TMA maps)
    for (s, hq, hkv, d), dtype in (((70, 4, 2, 32), torch.float32),
                                   ((300, 8, 2, 128), torch.bfloat16)):
        x = torch.from_numpy(rng.standard_normal((2, s, hq, d)).astype(
            np.float32)).to(DEVICE, dtype)
        kv = torch.from_numpy(rng.standard_normal((2, s, hkv, d)).astype(
            np.float32)).to(DEVICE, dtype)
        parity.check(x.transpose(1, 2), kv.transpose(1, 2),
                     kv.transpose(1, 2), True)


def sass_count(lib_path: str, opcode: str) -> int:
    """Instructions of ``opcode`` in a built library's SASS, by the
    ``cuobjdump`` of the toolkit that built it."""
    from repro_torch.kernels import _build

    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", lib_path],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    return len(re.findall(rf"\b{opcode}\b", sass))


def counts_now(ops, ref) -> dict:
    return {"kernel": dict(ops.counts), "plain": dict(ref.counts)}


def reset_counts(*tables) -> None:
    for table in tables:
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
# serving
# ---------------------------------------------------------------------------


def serve_main_path(torch, count_tables, fa_ops, fa_ref, card: str) -> dict:
    """Phase 6: the serving run on the card; returns what phase 7 needs."""
    from repro_torch import configs
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serving import ServeConfig, ServingEngine

    cfg = dataclasses.replace(configs.get_config(SERVE_ARCH),
                              attention_impl="pallas")
    max_len = SERVE_PROMPT + SERVE_NEW
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                        device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    print(f"serve: {cfg.name} at full width and depth ({cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.n_heads} q / "
          f"{cfg.n_kv_heads} kv heads x {cfg.head_dim}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}, {cfg.norm}), {cfg.dtype}: {n_params} "
          f"weights ({cfg.param_count()} by ModelConfig.param_count, which "
          f"leaves out the norms), made on the card from seed 0 in "
          f"{init_s:.2f} s")
    rng = np.random.default_rng(0)
    requests = [rng.integers(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT))
                .astype(np.int32) for _ in range(SERVE_REQUESTS)]
    engine = ServingEngine(cfg, model, ServeConfig(max_len=max_len),
                           device=DEVICE)

    reset_counts(*count_tables)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    outs, per_request = [], []
    for prompts in requests:
        before = engine.stats
        outs.append(engine.generate(prompts, SERVE_NEW))
        after = engine.stats
        per_request.append((after["prefill_s"] - before["prefill_s"],
                            after["decode_s"] - before["decode_s"]))
    counted = {"kernel": dict(fa_ops.counts), "plain": dict(fa_ref.counts)}
    peak = torch.cuda.max_memory_allocated()
    print(f"serve path counts: {counted}")
    want = cfg.n_layers * SERVE_REQUESTS
    if counted["kernel"] != {"flash_attention": want, "tensor_core": want,
                             "tf32x3": 0}:
        raise AssertionError(f"the serving run did not launch the "
                             f"tensor-core flash kernel, and only it, {want} "
                             f"times: {counted['kernel']}")
    if any(counted["plain"].values()):
        raise AssertionError("the serving run ran the plain version")
    for out in outs:
        if out.shape != (SERVE_BATCH, SERVE_NEW) or out.dtype != np.int32 \
                or not ((out >= 0) & (out < cfg.vocab_size)).all():
            raise AssertionError(f"bad generated tokens {out.shape} "
                                 f"{out.dtype}")
    for i, (pre_s, dec_s) in enumerate(per_request):
        print(f"  request {i}: prefill {pre_s:.4f} s, decode {dec_s:.4f} s "
              f"({SERVE_BATCH * SERVE_NEW / dec_s:.1f} tok/s) [{card}]")
    st = engine.stats
    print(f"serve totals: {SERVE_REQUESTS} requests of batch {SERVE_BATCH} x "
          f"prompt {SERVE_PROMPT} x {SERVE_NEW} new tokens: prefill "
          f"{st['prefill_s']:.4f} s, decode {st['decode_s']:.4f} s, "
          f"{st['tokens']} tokens, {engine.tokens_per_s:.1f} tok/s; "
          f"max_memory_allocated {peak} B [{card}]")

    batch = {"tokens": torch.as_tensor(requests[0], dtype=torch.int64,
                                       device=DEVICE)}
    print("profile of one prefill (warm):")
    profiled(torch, lambda: prefill(cfg, model, batch, max_len))
    cache = prefill(cfg, model, batch, max_len)[1]
    tok = torch.as_tensor(outs[0][:, :1], dtype=torch.int64, device=DEVICE)
    print("profile of one decode step (warm, at position "
          f"{SERVE_PROMPT}):")
    profiled(torch, lambda: decode_step(cfg, model, cache, tok))
    del cache
    return {"cfg": cfg, "model": model, "requests": requests, "outs": outs,
            "counts": counted}


def serve_against_plain(torch, fa_ref, srv: dict) -> None:
    """Phase 7, bf16 part: the first request's prefill logits and greedy
    tokens against ``attention_impl="reference"`` on the same weights.

    bf16 rounds each layer's attention output, so two correct attention
    paths end 32 layers later a few bf16 ulps of logit apart.  The floor
    of that noise is measured on the card by running the same model with
    the kernel's plain version (the same function in plain PyTorch) in
    the kernel's place.  The kernel path passes when its mean deviation
    from the reference path is within 1.1 times the floor's, and its
    largest within 5% of the logits' standard deviation or within 1.5
    times the floor's largest."""
    from unittest import mock

    from repro_torch.models import attention, prefill
    from repro_torch.serving import ServeConfig, ServingEngine

    cfg, model = srv["cfg"], srv["model"]
    plain_cfg = dataclasses.replace(cfg, attention_impl="reference")
    max_len = SERVE_PROMPT + SERVE_NEW
    prompts = srv["requests"][0]
    batch = {"tokens": torch.as_tensor(prompts, dtype=torch.int64,
                                       device=DEVICE)}
    lk = prefill(cfg, model, batch, max_len)[0].float()
    lr = prefill(plain_cfg, model, batch, max_len)[0].float()
    with mock.patch.object(attention, "flash_ops", types.SimpleNamespace(
            flash_attention=fa_ref.flash_attention)):
        lp = prefill(cfg, model, batch, max_len)[0].float()
    for name, logits in (("kernel", lk), ("reference", lr), ("floor", lp)):
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{name} prefill logits are not finite")
    std = float(lr.std())
    dev = {}
    for name, logits in (("kernel", lk), ("floor", lp)):
        d = (logits - lr).abs()
        dev[name] = (float(d.max()), float(d.mean()))
        print(f"bf16 last-position prefill logits, {name} path against the "
              f"reference path: max abs diff {dev[name][0]:.6f} "
              f"({dev[name][0] / std:.5f} of the logits' std {std:.6f}), "
              f"mean abs diff {dev[name][1]:.6f}, same argmax in "
              f"{float((logits.argmax(-1) == lr.argmax(-1)).float().mean()):.4f}"
              f" of rows")
    if dev["kernel"][1] > 1.1 * dev["floor"][1] or dev["kernel"][0] > max(
            0.05 * std, 1.5 * dev["floor"][0]):
        raise AssertionError("the kernel path's logits drift from the "
                             "reference path's beyond bf16's floor")
    plain = ServingEngine(plain_cfg, model, ServeConfig(max_len=max_len),
                          device=DEVICE).generate(prompts, SERVE_NEW)
    same = plain == srv["outs"][0]
    print(f"bf16 greedy tokens, kernel against plain path: agreement "
          f"{float(same.mean()):.4f} of {plain.size}; "
          f"{int(same.all(axis=1).sum())} of {SERVE_BATCH} rows equal "
          f"throughout")


def f32_greedy_check(torch, fa_ops, prompts: np.ndarray) -> int:
    """Phase 7, f32 part: full width cut to F32_LAYERS layers; every
    greedy token equal between kernel and plain paths.  Returns the
    launches of the split-TF32 flash kernel, the route of f32, on the
    kernel path."""
    from repro_torch import configs
    from repro_torch.models import init_params, prefill
    from repro_torch.serving import ServeConfig, ServingEngine

    cfg = dataclasses.replace(configs.get_config(SERVE_ARCH),
                              n_layers=F32_LAYERS, dtype="float32")
    max_len = SERVE_PROMPT + SERVE_NEW
    model = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                        device=DEVICE)
    batch = {"tokens": torch.as_tensor(prompts, dtype=torch.int64,
                                       device=DEVICE)}
    outs, logits = {}, {}
    reset_counts(fa_ops.counts)
    for impl in ("pallas", "reference"):
        c = dataclasses.replace(cfg, attention_impl=impl)
        logits[impl] = prefill(c, model, batch, max_len)[0]
        outs[impl] = ServingEngine(c, model, ServeConfig(max_len=max_len),
                                   device=DEVICE).generate(prompts, SERVE_NEW)
    launched = dict(fa_ops.counts)
    if launched != {"flash_attention": 2 * F32_LAYERS, "tensor_core": 0,
                    "tf32x3": 2 * F32_LAYERS}:
        raise AssertionError(f"the f32 kernel path did not launch the "
                             f"split-TF32 flash kernel once a layer in each "
                             f"of its 2 prefills: {launched}")
    diff = float((logits["pallas"] - logits["reference"]).abs().max())
    same = int((outs["pallas"] == outs["reference"]).sum())
    print(f"f32, {F32_LAYERS} layers at full width: prefill logits max abs "
          f"diff {diff:.3e}; greedy tokens equal {same} of "
          f"{outs['pallas'].size}")
    if same != outs["pallas"].size:
        raise AssertionError("f32 greedy tokens differ between the kernel "
                             "and plain paths")
    return launched["tf32x3"]


def flash_timing(torch, fa_ops, fa_ref, fparity: FlashParity, cfg,
                 card: str) -> dict:
    """Phase 8: each flash kernel, the plain version and SDPA at the
    prefill shape, on the model's layout ((B, S, H, D) viewed as
    (B, H, S, D)): the tensor-core route in bf16, the split-TF32 route in
    f32 (TF32 off for the plain version and SDPA).  Returns each route's timing."""
    import torch.nn.functional as F

    b, h, l, d = SERVE_BATCH, cfg.n_heads, SERVE_PROMPT, cfg.head_dim
    # causal, Lq == Lk: l (l + 1) / 2 visible (row, column) pairs, each a
    # d-long dot product and a d-long weighted sum (2 FLOP a term); bytes:
    # q, k, v read once and out written once
    timing = {}
    # the prefill shape on each route, then at zamba2-7b's head_dim 112 in
    # f32 (the split-TF32 kernel's widest instantiation below 128)
    for dtype, peak, products, d, key in (
            (torch.bfloat16, PEAK_BF16_FLOP_PER_S, 1, d, None),
            (torch.float32, PEAK_TF32_FLOP_PER_S, TF32_SPLIT_PRODUCTS, d,
             None),
            (torch.float32, PEAK_TF32_FLOP_PER_S, TF32_SPLIT_PRODUCTS, 112,
             "tf32x3_d112")):
        flop = 4 * b * h * d * (l * (l + 1) // 2)
        which = fa_ops.route(dtype, d)
        rng = np.random.default_rng(1)
        q, k, v = (torch.from_numpy(rng.standard_normal((b, l, h, d)).astype(
            np.float32)).to(DEVICE, dtype).transpose(1, 2) for _ in range(3))
        fparity.check(q, k, v, True)
        sdpa_err = float((F.scaled_dot_product_attention(q, k, v,
                                                         is_causal=True)
                          .float() - fa_ref.flash_attention(q, k, v).float())
                         .abs().max())
        qkv = (q, k, v)
        out = {
            "ms": time_ms(torch, lambda a=qkv: fa_ops.flash_attention(*a)),
            "plain_ms": time_ms(torch,
                                lambda a=qkv: fa_ref.flash_attention(*a),
                                reps=5),
            "library_ms": time_ms(
                torch, lambda a=qkv: F.scaled_dot_product_attention(
                    *a, is_causal=True)),
        }
        n_bytes = 4 * b * h * l * d * q.element_size()
        out["bound_ms"], out["bound_by"] = bound_ms(n_bytes, products * flop,
                                                    peak)
        if dtype == torch.float32 and key is None:
            # the CUDA-core design's bound: f32 FMAs at 67 TFLOP/s
            out["ffma_bound_ms"] = bound_ms(n_bytes, flop)[0]
        out.update(shape=[b, h, l, l, d], flop=flop, bytes=n_bytes,
                   dtype=str(dtype).split(".")[-1],
                   tflop_s=flop / out["ms"] / 1e9,
                   bound_share=out["bound_ms"] / out["ms"])
        print(f"flash_attention ({which}) at B {b} H {h} L {l} D {d} "
              f"{out['dtype']} causal: kernel {out['ms']:.4f} ms "
              f"({out['tflop_s']:.1f} TFLOP/s, {out['bound_share']:.4f} of "
              f"the bound), "
              f"plain {out['plain_ms']:.4f} ms, SDPA {out['library_ms']:.4f} "
              f"ms (its max abs diff from the plain version "
              f"{sdpa_err:.3e}), bound {out['bound_ms']:.4f} ms "
              f"({out['bound_by']}: {products} x {flop:.4e} FLOP at "
              f"{peak:.3g} FLOP/s, {n_bytes} B)"
              + (f"; f32 FMA bound {out['ffma_bound_ms']:.4f} ms"
                 if "ffma_bound_ms" in out else "") + f" [{card}]")
        timing[key or which] = out
        del q, k, v, qkv
    return timing


# ---------------------------------------------------------------------------
# the decision walk, the cluster and the expert prefetcher on the card
# ---------------------------------------------------------------------------

#: bench_cluster's largest static configuration, full sweep
CLUSTER_SHARDS, CLUSTER_TENANTS, CLUSTER_TX = 8, 16, 250
#: bench_overhead's decision sweep: live contexts, steady ops a pass
DECISION_WINDOWS, DECISION_TAIL, DECISION_REPS = (1, 16, 64), 256, 5


def decision_phase(torch, core, client, stage2, card: str) -> dict:
    """Phase 9: the ``"torch"`` decision engine on the card in lockstep
    with the numpy engine over the SEQB client's mined index and the
    stage-2 requests, for each heuristic; then the per-op cost of both at
    1, 16 and 64 live contexts on ``bench_overhead``'s chain forest."""
    index, db = client.engine.index, client.logger.db
    items = [db.item_id(key) for sess in stage2 for key in sess]
    walks = {}
    for name in ("fetch_all", "fetch_progressive", "fetch_top_n"):
        cfg = core.HeuristicConfig(name, top_n=5)
        host = core.VectorizedPrefetchEngine(index, cfg, 256)
        dev = core.VectorizedPrefetchEngine(index, cfg, 256, backend="torch",
                                            device=DEVICE)
        walked = prefetched = 0
        for i, item in enumerate(items):
            walked += dev.n_live > 0       # a step of the walk on the card
            want = host.on_request(item)
            if dev.on_request(item) != want or dev.n_live != host.n_live:
                raise AssertionError(f"the torch decision engine differs from "
                                     f"the numpy one at op {i} ({name})")
            prefetched += len(want)
        walks[name] = walked
        print(f"decision walk, {name}: {len(items)} stage-2 requests over "
              f"{len(index)} trees, equal waves at every op ({prefetched} "
              f"items), {walked} of them advanced live contexts on the card")
    if walks["fetch_progressive"] == 0:
        raise AssertionError("no request advanced a context on the card")
    cost, busy = {}, {}
    for window in DECISION_WINDOWS:
        length = window + DECISION_TAIL
        forest = chain_forest(core, window, length)
        stream = list(range(length))
        cfg = core.HeuristicConfig("fetch_progressive", progressive_depth=3)
        for backend in ("numpy", "torch"):
            kw = {"device": DEVICE} if backend == "torch" else {}
            eng = core.VectorizedPrefetchEngine(forest, cfg, 256,
                                                backend=backend, **kw)

            def steady(eng=eng, stream=stream, window=window):
                for item in stream[window + 1:]:
                    eng.on_request(item)

            passes = []
            for _ in range(DECISION_REPS + 1):         # the first warms up
                eng.replace_index(forest)
                for item in stream[:window + 1]:
                    eng.on_request(item)
                t0 = time.perf_counter()
                steady()
                passes.append(time.perf_counter() - t0)
            cost[backend, window] = (statistics.median(passes[1:]) * 1e6
                                     / (length - window - 1))
        # where the card's op goes: one steady pass under the profiler
        eng.replace_index(forest)
        for item in stream[:window + 1]:
            eng.on_request(item)
        print(f"profile of the torch engine's steady pass at {window} live "
              f"contexts ({length - window - 1} ops):")
        _, busy[window] = profiled(torch, steady)
        print(f"decision cost at {window} live contexts: numpy "
              f"{cost['numpy', window]:.2f} us an op, torch on the card "
              f"{cost['torch', window]:.2f} us an op "
              f"({cost['torch', window] / cost['numpy', window]:.2f}x) [{card}]")
    return {"walks": walks, "busy_share": busy,
            "us_per_op": {f"{b}_ctx{w}": c for (b, w), c in cost.items()}}


def cluster_run(torch, core, ops, ref, device) -> dict:
    """Stage 1 (seed 3), a mine of every tenant, the gossip round, stage
    2 (seed 7) on fresh statistics: the 8-shard, 16-tenant cluster."""
    gen = TPCC(TPCCConfig())
    store = core.ShardedDKVStore(CLUSTER_SHARDS)
    store.load(gen.dataset())
    cluster = core.ClusterClient(store, core.ClusterConfig(
        n_clients=CLUSTER_TENANTS, palpatine=cluster_config(core)),
        device=device)
    t0 = time.perf_counter()
    cluster.run(tenant_streams(gen, CLUSTER_TENANTS, CLUSTER_TX, seed=3))
    stage1_s = time.perf_counter() - t0
    # mine_all, tenant by tenant: no backlog is unchanged, so mine_all
    # would mine each of them the same way
    if any(t.backlog_unchanged_since_mine() for t in cluster.tenants):
        raise AssertionError("a tenant's backlog did not grow in stage 1")
    per_tenant = []
    on_card = device != "cpu"
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in cluster.tenants:
        before = dict(ops.counts), dict(ref.counts)
        t.mine_now()
        per_tenant.append(
            (ops.counts["frontier_join_support"]
             - before[0]["frontier_join_support"],
             sum(ref.counts[n] - before[1][n] for n in ref.counts)))
    if on_card:
        torch.cuda.synchronize()
    mine_s = time.perf_counter() - t0
    cluster.exchange_patterns()
    cluster.reset_stats()
    t0 = time.perf_counter()
    lats = cluster.run(tenant_streams(gen, CLUSTER_TENANTS, CLUSTER_TX,
                                      seed=7))
    stage2_s = time.perf_counter() - t0
    return {"cluster": cluster, "lats": lats, "per_tenant": per_tenant,
            "stage1_s": stage1_s, "mine_s": mine_s, "stage2_s": stage2_s,
            "agg": cluster.aggregate_stats(),
            "per_shard": cluster.per_shard_stats(),
            "patterns": [(p.items, p.support) for p in cluster.exchange.store],
            "col_patterns": [(p.items, p.support)
                             for p in cluster.exchange.col_store],
            "sessions": [len(t.logger.db) for t in cluster.tenants],
            "items": [t.logger.db.n_items for t in cluster.tenants]}


def cluster_phase(torch, core, ops, ref, card: str) -> dict:
    """Phase 10: ``bench_cluster``'s largest static configuration (8
    shards, 16 tenants, 250 TPC-C transactions a tenant a stage) with
    every tenant mining on the card, beside the baseline and the same run
    on the CPU."""
    run = cluster_run(torch, core, ops, ref, DEVICE)
    launches = sum(n for n, _ in run["per_tenant"])
    if any(n == 0 or plain for n, plain in run["per_tenant"]):
        raise AssertionError(f"a tenant's mine did not launch the frontier "
                             f"kernel, or ran a plain version: "
                             f"{run['per_tenant']}")
    gen = TPCC(TPCCConfig())
    store = core.ShardedDKVStore(CLUSTER_SHARDS)
    store.load(gen.dataset())
    base = core.ClusterBaseline(store, CLUSTER_TENANTS).run(
        tenant_streams(gen, CLUSTER_TENANTS, CLUSTER_TX, seed=7))
    lats = [x for ls in run["lats"] for x in ls]
    base_lats = [x for ls in base for x in ls]
    mean_us, base_us = np.mean(lats) * 1e6, np.mean(base_lats) * 1e6
    if not mean_us < base_us:
        raise AssertionError(f"the cluster's mean read latency {mean_us} us "
                             f"does not beat the baseline's {base_us} us")
    cpu = cluster_run(torch, core, ops, ref, "cpu")
    for key in ("lats", "agg", "per_shard", "patterns", "col_patterns"):
        if cpu[key] != run[key]:
            raise AssertionError(f"the cluster on the CPU differs from the "
                                 f"card's in {key}")
    agg = run["agg"]
    print(f"cluster: {CLUSTER_SHARDS} shards, {CLUSTER_TENANTS} tenants x "
          f"{CLUSTER_TX} TPC-C transactions a stage ({run['sessions'][0]} "
          f"sessions, {run['items'][0]} items in tenant 0's log); stage 2: "
          f"{len(lats)} reads, hit rate {agg.hit_rate:.4f}, mean "
          f"{mean_us:.2f} us, p99 {core.percentile(lats, 99.0) * 1e6:.2f} us "
          f"against the baseline's {base_us:.2f} us, p99 "
          f"{core.percentile(base_lats, 99.0) * 1e6:.2f} us (virtual clock); "
          f"{len(run['patterns'])} row and {len(run['col_patterns'])} column "
          f"patterns exchanged; equal to the CPU run in latencies, "
          f"statistics, per-shard statistics and patterns")
    print(f"cluster walls: stage 1 {run['stage1_s']:.2f} s, mine_all "
          f"{run['mine_s']:.2f} s on the card ({launches} frontier launches, "
          f"0 plain) against {cpu['mine_s']:.2f} s on the CPU, stage 2 "
          f"{run['stage2_s']:.2f} s [{card}]")
    tenant = run["cluster"].tenants[0]
    t0 = time.perf_counter()
    tenant.mine_now()
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    print(f"profile of tenant 0's warm mine_now ({warm_ms:.1f} ms wall "
          f"unprofiled) [{card}]:")
    prof, busy = profiled(torch, tenant.mine_now)
    f_ms, f_n = kernel_total(prof, "frontier_join_kernel")
    print(f"  frontier kernels {f_ms:.3f} ms over {f_n} launches [{card}]")
    return {"launches": launches, "mine_s": run["mine_s"],
            "cpu_mine_s": cpu["mine_s"], "busy_share": busy,
            "warm_mine_ms": warm_ms}


def prefetcher_phase(torch, core, serving, ops, ref, card: str) -> dict:
    """Phase 11: ``bench_serving``'s full closed loop (4 shards, 500
    requests) for each traffic shape, served by expert prefetchers that
    mine on the card, against the same loop on the CPU."""
    out = {"launches": 0, "wall_s": {}, "cpu_wall_s": {}}
    for i, shape in enumerate(serving.SHAPES):
        reset_counts(ops.counts, ref.counts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run = prefetcher_loop(core, serving, shape, False, i, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = ops.counts["frontier_join_support"]
        if launched == 0 or any(ref.counts.values()):
            raise AssertionError(f"the prefetchers' mines did not run on the "
                                 f"frontier kernel alone: "
                                 f"{counts_now(ops, ref)}")
        store = run["store"]
        value = store.decode(store.weights[0, 0].tobytes())
        if not (isinstance(value, torch.Tensor)
                and value.device.type == torch.device(DEVICE).type):
            raise AssertionError(f"ExpertStore.decode did not give a tensor "
                                 f"on {DEVICE}")
        t0 = time.perf_counter()
        cpu = prefetcher_loop(core, serving, shape, False, i, device="cpu")
        cpu_wall = time.perf_counter() - t0
        for key in ("lats", "mined", "stats", "exchanged"):
            if cpu[key] != run[key]:
                raise AssertionError(f"the prefetchers on the CPU differ from "
                                     f"the card's in {key} ({shape})")
        lats = [x for ls in run["lats"] for x in ls]
        st = run["stats"]
        hits = sum(s["prefetch_hits"] for s in st)
        print(f"expert prefetcher, {shape}: {len(lats)} reads, hit rates "
              f"{', '.join('%.4f' % s['hit_rate'] for s in st)}, "
              f"{hits} prefetch hits, mean {np.mean(lats) * 1e6:.2f} us, p99 "
              f"{core.percentile(lats, 99.0) * 1e6:.2f} us (virtual clock); "
              f"mined {run['mined']}, {len(run['exchanged'])} patterns "
              f"exchanged; {launched} frontier launches, 0 plain; equal to "
              f"the CPU run; wall {wall:.2f} s on the card, {cpu_wall:.2f} s "
              f"on the CPU [{card}]")
        out["launches"] += launched
        out["wall_s"][shape], out["cpu_wall_s"][shape] = wall, cpu_wall
        pf = run["prefetchers"][0]
    value, _ = pf.read((0, 0))
    if value.device.type != torch.device(DEVICE).type:
        raise AssertionError(f"a prefetcher read gave no tensor on {DEVICE}")
    print(f"profile of a prefetcher's warm mine_now [{card}]:")
    _, out["busy_share"] = profiled(torch, pf.mine_now)
    return out


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
    t_start = time.perf_counter()
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch import core
    from repro_torch.kernels import _build
    from repro_torch.kernels.bitmap_support import ops, ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    # float32 matmuls in true f32 (TF32 off, also PyTorch's default), so
    # the plain versions and the f32 serving check are exact f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    count_tables = (ops.counts, ref.counts, fa_ops.counts, fa_ref.counts)

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
    # one nvcc per source, started together
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        futs = {"bitmap_support": pool.submit(ops.load),
                **{r: pool.submit(fa_ops.load, r) for r in fa_ops.ROUTES}}
        libs = {name: fut.result() for name, fut in futs.items()}
    build_s = time.perf_counter() - t0
    for name, lib in libs.items():
        # lib<name>_<digest>.so
        log = _build.build_logs.get(Path(lib._name).stem[3:].rsplit("_", 1)[0])
        print(f"{name}: {'found already built' if log is None else 'built now'}"
              f" as {lib._name}")
        for line in (log or "").splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling",
                                       "warning", "Performance")):
                print("  ptxas:", line.strip())
    print(f"kernel build + load, {len(libs)} libraries: {build_s:.2f} s")
    tc = libs["tensor_core"]
    for d in (64, 128):
        print(f"tensor-core flash kernel at head_dim {d}: "
              f"{tc.flash_attention_wgmma_smem_bytes(d)} B of dynamic "
              f"shared memory a block")
    # the tensor-core instructions each flash kernel must hold: warpgroup
    # products (HGMMA) in the bf16 kernel, mma.sync (HMMA) in split TF32
    tc_instructions = {}
    for which, opcode in (("tensor_core", "HGMMA"), ("tf32x3", "HMMA")):
        tc_instructions[which] = sass_count(libs[which]._name, opcode)
        print(f"{FLASH_KERNELS[which][0]} SASS: {tc_instructions[which]} "
              f"{opcode} instructions")
        if tc_instructions[which] == 0:
            raise AssertionError(f"the {which} flash kernel has no {opcode} "
                                 f"instruction")

    # -- phase 2: kernel parity on edge grids ---------------------------
    parity = Parity(torch, ops, ref)
    edge_parity(torch, parity)
    print(f"parity: {parity.cases} edge cases exact")
    fparity = FlashParity(torch, fa_ops, fa_ref)
    flash_edge_parity(torch, fparity)
    print(f"flash parity (causal and not): {fparity.summary()}")

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

    reset_counts(*count_tables)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_stored = client.mine_now()
    torch.cuda.synchronize()
    mine_s = time.perf_counter() - t0
    main_counts = counts_now(ops, ref)
    print(f"main path counts: {main_counts}")
    if fa_ops.counts["flash_attention"] or fa_ref.counts["flash_attention"]:
        raise AssertionError("the mine ran flash attention")
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
    frontier_ms, frontier_n = kernel_total(profiled(torch, direct_mine)[0],
                                           "frontier_join_kernel")
    print(f"  frontier kernels in the warm mine: {frontier_ms:.3f} ms over "
          f"{frontier_n} launches [{card}]")
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
    cand_t = ops.session_major(cand)
    slots = vb.extension_slots(cand, cfg.mining.maxgap).contiguous()
    # the s-step join of the densest DFS node (the best root) and of a
    # median one (the root of median support); a child is never denser
    # than its parent
    order = np.argsort(vb.freq_support[rows], kind="stable")
    sstep_slots = {
        where: vb.extension_slots(cand[int(i)], cfg.mining.maxgap).contiguous()
        for where, i in (("root", order[-1]), ("median", order[len(order) // 2]))}
    root_slots = sstep_slots["root"]
    parity.frontier(slots, cand, "first level")
    for sl in sstep_slots.values():
        parity.sstep(sl, cand)
    p_, k_, s_, w_ = (*slots.shape[:1], *cand.shape)
    # the frontier kernel at the same shape on random words, where every
    # (prefix, session) pair is nonzero and nothing can be skipped
    frng = np.random.default_rng(2)
    full_slots = random_words(torch, frng, tuple(slots.shape))
    full_cand = random_words(torch, frng, tuple(cand.shape))
    full_cand_t = ops.session_major(full_cand)
    parity.frontier(full_slots, full_cand, "every pair nonzero")
    # bounds: each input read once, each output written once; the frontier
    # join needs one AND per (nonzero slot word, candidate) of this data
    # (dense_bound_ms: the operations of all P*K*S*W)
    nnz = int((slots != 0).sum())
    f_bound, f_by = bound_ms((p_ + k_) * s_ * w_ * 4 + p_ * k_ * 4, nnz * k_)
    f_dense, _ = bound_ms(0, p_ * k_ * s_ * w_)
    s_dense, _ = bound_ms(2 * k_ * s_ * w_ * 4 + s_ * w_ * 4 + k_ * 4,
                          k_ * s_ * w_)
    # the s-step join's data bound: joined written whole, the slots and
    # support once, and the K candidate words of each session where the
    # slot row is nonzero (a zero slot word needs no candidate word)
    sstep = {}
    for where, sl in sstep_slots.items():
        listed = int((sl != 0).any(-1).sum())
        bound, by = bound_ms(k_ * s_ * w_ * 4 + s_ * w_ * 4 + k_ * 4
                             + listed * k_ * w_ * 4, listed * k_ * w_)
        sw = device_work(torch, lambda a=sl: ops.sstep_join_support(a, cand))
        kms = sum(ms for op, ms in sw["by_name"].items()
                  if "sstep_join_kernel" in op)
        sstep[where] = dict(listed=listed, bound_ms=bound, bound_by=by,
                            device_ms=sw["ms"], kernel_device_ms=kms,
                            device_ops=sw["ops"])
        print(f"sstep_join_support at the {where} node ({listed} of {s_} "
              f"sessions nonzero): device time {sw['ms']:.4f} ms a call in "
              f"{sw['ops']:.1f} device operations ({', '.join(sorted(sw['by_name']))[:160]}), "
              f"of it the kernel {kms:.4f} ms ({bound / kms:.4f} of this "
              f"data's bound {bound:.6f} ms, {by}); dense bound "
              f"{s_dense:.6f} ms [{card}]")
    work = device_work(torch, lambda: ops.frontier_join_support(
        slots, cand, cand_t))
    full_work = device_work(torch, lambda: ops.frontier_join_support(
        full_slots, full_cand, full_cand_t))
    kernel_ms = {name: sum(ms for op, ms in w["by_name"].items()
                           if "frontier_join_kernel" in op)
                 for name, w in (("sparse", work), ("full", full_work))}
    timing = {
        "frontier_join_support": dict(
            ms=time_ms(torch, lambda: ops.frontier_join_support(
                slots, cand, cand_t)),
            ms_full_density=time_ms(torch, lambda: ops.frontier_join_support(
                full_slots, full_cand, full_cand_t)),
            plain_ms=time_ms(torch, lambda: ref.frontier_join_support(
                slots, cand), reps=5),
            session_major_ms=time_ms(torch, lambda: ops.session_major(cand)),
            bound_ms=f_bound, bound_by=f_by, dense_bound_ms=f_dense,
            device_ms=work["ms"], kernel_device_ms=kernel_ms["sparse"],
            kernel_device_ms_full_density=kernel_ms["full"],
            launches_per_call=work["ops"], shape=[p_, k_, s_, w_],
            nonzero_slot_words=nnz),
        "sstep_join_support": dict(
            ms=time_ms(torch, lambda: ops.sstep_join_support(root_slots, cand)),
            ms_median=time_ms(torch, lambda: ops.sstep_join_support(
                sstep_slots["median"], cand)),
            plain_ms=time_ms(torch, lambda: ref.sstep_join_support(
                root_slots, cand)),
            bound_ms=sstep["root"]["bound_ms"],
            bound_by=sstep["root"]["bound_by"], dense_bound_ms=s_dense,
            device_ms=sstep["root"]["device_ms"],
            kernel_device_ms=sstep["root"]["kernel_device_ms"],
            launches_per_call=sstep["root"]["device_ops"],
            nonzero_slot_sessions=sstep["root"]["listed"],
            median_bound_ms=sstep["median"]["bound_ms"],
            median_kernel_device_ms=sstep["median"]["kernel_device_ms"],
            median_nonzero_slot_sessions=sstep["median"]["listed"],
            shape=[k_, s_, w_]),
    }
    for name, t in timing.items():
        print(f"{name} at {t['shape']}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}) [{card}]")
    t = timing["frontier_join_support"]
    print(f"frontier_join_support: {t['launches_per_call']:.1f} device "
          f"operations a call ({', '.join(sorted(work['by_name']))}); "
          f"device time {t['device_ms']:.4f} ms a call, of it the kernel "
          f"{t['kernel_device_ms']:.4f} ms ({f_bound / t['kernel_device_ms']:.4f} "
          f"of the bound); {nnz} nonzero slot words of {p_ * s_ * w_}; on "
          f"random words (every pair nonzero): {t['ms_full_density']:.4f} ms "
          f"one launch, kernel {t['kernel_device_ms_full_density']:.4f} ms "
          f"on the device; the walk's session-major copy of cand "
          f"{t['session_major_ms']:.4f} ms, once a walk [{card}]")

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
    reset_counts(*count_tables)
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
    print("profile of the spill mine (warm):")
    spill_prof, spill_busy = profiled(torch, lambda: core.mine_dynamic_minsup(
        db, dataclasses.replace(cfg.mining, frontier_budget=1), cfg.algo,
        device=DEVICE, **dyn))
    spill_sstep_ms, spill_sstep_n = kernel_total(spill_prof,
                                                 "sstep_join_kernel")
    print(f"  s-step kernels in the spill mine: {spill_sstep_ms:.3f} ms over "
          f"{spill_sstep_n} launches ({spill_sstep_ms / spill_sstep_n * 1e3:.2f}"
          f" us each); busy share {spill_busy:.4f} [{card}]")
    timing["sstep_join_support"].update(
        spill_wall_ms=spill_s * 1e3, spill_kernel_device_ms=spill_sstep_ms,
        spill_busy_share=spill_busy)

    # -- phase 5: card against CPU --------------------------------------
    # the same client on the CPU (plain versions), same store and traffic:
    # its mine and every stage-2 (value, latency) must equal the card's
    cpu_client = core.PalpatineClient(make_store(), cfg, device="cpu")
    for sess in stage1:
        for key in sess:
            cpu_client.read(key)
        cpu_client.end_session()
    reset_counts(ops.counts, ref.counts)
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

    # -- phase 6: serving path ------------------------------------------
    srv = serve_main_path(torch, count_tables, fa_ops, fa_ref, card)

    # -- phase 7: serving against the plain path -------------------------
    serve_against_plain(torch, fa_ref, srv)
    serve_cfg, first_prompts = srv["cfg"], srv["requests"][0]
    serve_counts = srv["counts"]
    del srv                         # frees the bf16 model
    torch.cuda.empty_cache()
    f32_launches = f32_greedy_check(torch, fa_ops, first_prompts)
    torch.cuda.empty_cache()

    # -- phase 8: flash timing at the prefill shape -----------------------
    flash = flash_timing(torch, fa_ops, fa_ref, fparity, serve_cfg, card)

    # -- phase 9: the decision walk on the card ----------------------------
    t0 = time.perf_counter()
    decision = decision_phase(torch, core, client, stage2, card)
    phase_s = {"decision": time.perf_counter() - t0}

    # -- phase 10: the sharded cluster, its tenants mining on the card -----
    t0 = time.perf_counter()
    cluster = cluster_phase(torch, core, ops, ref, card)
    phase_s["cluster"] = time.perf_counter() - t0

    # -- phase 11: the expert prefetcher on the card -----------------------
    from repro_torch import serving

    t0 = time.perf_counter()
    prefetch = prefetcher_phase(torch, core, serving, ops, ref, card)
    phase_s["prefetcher"] = time.perf_counter() - t0
    print("new phases' seconds: " + ", ".join(
        f"{name} {sec:.1f}" for name, sec in phase_s.items()))

    # -- phase 12: the kernels line and the result ------------------------
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
            **{key: t[key] for key in t if key not in (
                "ms", "plain_ms", "bound_ms", "bound_by", "shape")},
        })
    # the frontier kernel also carries the cluster's and the prefetchers'
    # mines
    kernels[0].update(
        cluster_launches=cluster["launches"],
        prefetcher_launches=prefetch["launches"],
        cluster_mine_all_s=cluster["mine_s"],
        cluster_mine_all_cpu_s=cluster["cpu_mine_s"],
        cluster_warm_mine_busy_share=cluster["busy_share"],
        prefetcher_walls_s=prefetch["wall_s"],
        prefetcher_mine_busy_share=prefetch["busy_share"])
    # the tensor-core kernel is the serve path's; the split-TF32 one runs
    # the f32 check of phase 7
    flash_paths = {"tensor_core": ("serve", serve_counts["kernel"]),
                   "tf32x3": ("f32_check", {"tf32x3": f32_launches})}
    for which, (name, source) in FLASH_KERNELS.items():
        path, counted = flash_paths[which]
        t = flash[which]
        kernels.append({
            "name": name, "route": "cuda", "ops_route": which,
            "source": source, "replaces": FLASH_TPU_KERNEL,
            "launches": counted[which], "path": path,
            "parity_cases": fparity.cases[which],
            "max_abs_err": fparity.max_abs_err(which),
            "max_abs_err_f32": fparity.max_err[which, "float32"],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "tflop_s": t["tflop_s"], "bound_share": t["bound_share"],
            "shape": t["shape"], "dtype": t["dtype"], "causal": True,
            "tensor_core_instructions": tc_instructions[which],
            **({"ffma_bound_ms": t["ffma_bound_ms"]}
               if "ffma_bound_ms" in t else {}),
        })
    d112 = flash["tf32x3_d112"]
    kernels[-1].update({f"d112_{key}": d112[key] for key in (
        "ms", "plain_ms", "library_ms", "bound_ms", "bound_share", "shape")})
    print(f"chip_smoke total: {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
