#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the root of a checkout, on a machine with one NVIDIA H100 and
the CUDA toolkit:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and none is caught:

1. Environment: torch, CUDA, ``nvcc``, the card's name and power limit,
   and the time to build the kernels from ``src/repro_torch`` (one
   ``nvcc`` per source, all started together; split TF32's optimizes in
   threads, ``ops._LIBRARIES``) and each library's, with ``ptxas``'s registers, shared
   memory and spills (a spill in any kernel, or a ``wgmma`` serialized,
   C7520, fails the phase); the
   tensor-core flash kernel's shared memory a block at each head_dim it is
   instantiated for and at head_dims past 128 (its wide kernel); the count
   of ``HGMMA`` (warpgroup tensor-core) instructions in the bf16 flash
   kernel's SASS (all of it, its instantiations at head_dim 112 and 128,
   and its wide kernel) and of ``HMMA`` (``mma.sync``) instructions in the
   split-TF32 one, by ``cuobjdump -sass``, each of which must be above 0;
   each flash library's blocks a q tile at every head_dim 16-1,024 equal
   to ``ops.out_chunks``; each instantiation of the wide tensor-core
   kernel holds as many ``HGMMA`` as the ``wgmma`` it counts a tile.
2. Kernel parity: both support-join kernels against their plain PyTorch
   versions on edge-case grids, requiring exact equality (the s-step
   kernel also on slots nonzero in 0.4%, 1% and 12.6% of the sessions,
   the densities of the SEQB spill walk; the frontier
   kernel also on the sparse grid of ``frontier_cases``: 0, 1, 10 and 100%
   of (prefix, session) pairs nonzero, one prefix in every session among
   empty ones, only the last of W > 1 words set, bit 31 only); both
   flash-attention kernels (the tensor-core route, bf16 at every head_dim,
   and the split-TF32 route, f32 at every head_dim) against their plain
   version on the grids of ``tests/test_kernels.py`` and more, with the
   tensor-core kernel's edges (ragged 1,000, Lq > Lk, Lq < Lk = 513, GQA
   56/8, MQA), its head_dims 16, 32, 48, 80, 96 and 112 (zamba2-7b's),
   zero-padded 40, 72 and 100, and past 128 (its wide kernel) 144, 160,
   192, 200 (zero-padded), 208, 240, 256, 272, 384, 400, 512, 528, 576
   and 1,024, each ragged with Lq < Lk under GQA and over three tiles
   under MQA; both kernels at 40, 48, 72, 80, 96 and 112 and, past 128,
   144, 160, 176, 192, 200, 224, 240 and 256 (200 zero-padded; split TF32
   by its own instantiations, one block a q tile); and the split-TF32
   kernel in f32 past 256 (its wide kernel) at 272, 384, 400, 512, 528,
   576 and 1,024; f32 within 2e-5 with TF32 off and bf16 within 2e-2.
   Past 128, in both dtypes, two launches on the same inputs must give
   the same bits.
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
   kernel (32 x 3), never the split-TF32 one and never the plain version;
   every decode step's layer the decode-attention kernel (32 x 32 x 3),
   never its plain version.  One prefill and one decode step are
   profiled.
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
   split-TF32 kernel in f32 at head_dims 112 and 256; in bf16, the share
   of outputs the tensor-core kernel rounds unlike the plain version, and
   its time and share with p in 3, 2 and 1 bf16 parts (``ops.P_PARTS``),
   and the wide kernel's share held below 1.25x the three parts' share
   at every head_dim past 128 (each kv tile's P.V summed from zero);
   the tensor-core kernel in bf16 at zamba2-7b's attention shape (head_dim
   112, phase 15's route) and past 128 at 256 and 512 (its wide kernel);
   the split-TF32 kernel in f32 at head_dim 512 (its wide kernel).  Past
   head_dim 128 each timing prints the products the kernel counted in one
   call (``ops.counted_products``), q.k and P.V apart, and how many times
   q.k was issued a (q tile, kv tile) pair.  Then the decode-attention
   kernel in bf16 at the benchmark's decode batch and at phase 6's batch
   4 (``decode_timing``): CUDA events over many launches on caches larger
   than the L2 and the profiler's device time, beside its bytes bound,
   the decode step's plain path, its plain version and SDPA on the valid
   slice.
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
   the CPU (run in a process of its own beside phases 9-20 and read after
   them); one profile of a tenant's warm ``mine_now``.
11. Expert prefetcher: ``bench_serving``'s full closed loop (4 shards,
   500 requests) for each traffic shape, one ``ExpertPrefetcher`` a
   tenant mining on the card (frontier kernel only, ``ExpertStore``
   decoding to CUDA tensors), its statistics equal to the same loop on
   the CPU; one profile of a prefetcher's warm ``mine_now``.
12-14. The vlm, audio and moe families (llava-next-mistral-7b and
   whisper-large-v3 at full width and depth, qwen3-moe-235b-a22b at full
   width cut to 8 of its 94 layers), bf16 weights from seed 0 made on the
   card, ``attention_impl="pallas"``, through the reference's model API:
   ``make_batch`` (batch 4; vlm 1,152 patches + 896 tokens, whisper 1,500
   frames + a 416-token prompt, moe a 2,048-token prompt), ``prefill``,
   then 32 greedy ``decode_step``s.  Each prefill launches the
   tensor-core flash kernel 32, 96 (32 encoder, 32 causal decoder, 32
   cross-attention) and 8 times, never the split-TF32 one or the plain
   version; every position's bf16 prefill logits meet phase 7's gate
   (moe's routing freely, with the token-layers each path routes unlike
   the reference path printed beside); at full width cut
   to 2 layers (whisper 2 + 2) in f32, the full-sequence logits of the
   kernel and plain paths agree within 1e-3 and their greedy tokens are
   equal (moe: rows where a near tie of two gates routed a token to other
   experts are counted and left out).  Warm prefill seconds, decode tok/s,
   peak memory and one profile each of a prefill and a decode step.
15. zamba2-7b (hybrid) at full width and depth, bf16, served as phase 6
   serves codeqwen (``ServingEngine``, 3 requests of batch 4 x prompt
   2,048 x 32 greedy tokens): every prefill launches the tensor-core flash
   kernel 13 times (once a use of the shared attention block, head_dim
   112), never the split-TF32 one or the plain version; every position's
   bf16 logits of the first prompt meet phase 7's gate; at full width cut
   to 13 layers (2 superblocks and a tail block) in f32 the kernel and
   plain paths' full-sequence logits agree within 1e-3 and their greedy
   tokens are equal; and the chunked full-sequence logits equal
   ``decode_step`` run token by token from zero states (the shared
   attention decoding against its growing KV cache) within 1e-3 on a
   300-token prompt (not a multiple of the 256-position chunk).
16. xlstm-1.3b (ssm) at full width and depth, bf16, served the same way:
   no flash launch at all (no attention); the sLSTM time loop's share of
   a prefill; at full width cut to 16 layers (2 superblocks) in f32 the
   chunked-against-recurrent check of phase 15.  Phases 15-16 print
   prefill s, decode tok/s, peak memory and one profile each of a prefill
   and a decode step (busy share, top device operations).
17. Training stablelm-1.6b (``TrainLoop``, ``make_steps``, AdamW,
   checkpoints): (a) at full width cut to 2 layers in f32, batch 1 x 512,
   one ``train_step`` of each attention (``"reference"``, ``"blocked"``)
   on the card and on the CPU from the same weights: the losses within
   1e-5, every gradient and every weight after the step within 1e-4 of
   its tensor's max-abs, and blocked against reference on the card the
   same; (b) at full width and depth in bf16 (``remat="full"``), batch 4
   x 2,048 on a fixed batch, one warm-up step and 5 timed ones of each
   attention: the first loss within (0.2 ln V, 3 ln V), the last below
   it, every gradient finite (the global norm), no flash call, the two
   first losses within 1e-2; warm seconds a step, tokens a second, model
   FLOPs and MFU, peak memory and one profiled step; (d) the trained
   model's ``prefill_step`` with ``attention_impl="pallas"`` launches the
   tensor-core flash kernel 24 times and its logits meet phase 7's gate;
   (e) its ``train_step`` with ``"pallas"`` raises; (c) at 2 layers in
   bf16, a checkpoint restored bitwise, the resumed run's losses within
   1e-4 of the uninterrupted run's, and ``run_with_restarts`` restarting
   once with 8 losses.
18. Sharding and launch on ``torch.distributed``, on a one-rank NCCL
   group started from a ``FileStore``, over a (1, 1) mesh: (a)
   stablelm-1.6b's ``TrainLoop(..., mesh=)`` at full width and depth
   (bf16, ``remat="full"``, 4 x 2,048, ``"reference"`` attention, 3
   steps), every parameter a DTensor: its first loss within 1e-4 relative
   of phase 17's unsharded loop's, and in f32 at 2 layers the sharded loss
   within 1e-6 of ``loss_fn``'s; (b) qwen3-moe-235b-a22b at phase 12's cut
   with ``moe_shard="ep_infer"`` through ``ServingEngine``: 8 tensor-core
   flash launches a prefill and nothing else, phase 12's bf16 gate, and
   in f32 at 2 layers the card's EP against the CPU's within
   ``F32_LOGITS_TOL``; (c) ``launch.dryrun.run_cell`` (in a process of its
   own) gives the bytes (a) held of parameters and moments, to the byte,
   then prints the production cells of stablelm-1.6b and qwen3-moe.
   (a) and (b) run the whole-weight path (every weight gathered whole at
   its use).
19. The ``model`` axis computing (tensor parallelism, ``sharding.tp``), on
   a one-rank NCCL group over a (1, 1) mesh: (a) phase 18 (a)'s
   ``TrainLoop(..., mesh=)`` tensor-parallel, its first loss within 1e-4
   relative of phase 17's and in f32 at 2 layers within 1e-6 of
   ``loss_fn``'s, its step beside phases 17 and 18's; (b) codeqwen1.5-7b
   at full width in bf16, placed by the inference specs, phase 6's
   requests through ``ServingEngine`` (the cache placed by
   ``cache_pspec``): 96 tensor-core flash launches and nothing else, phase
   7's bf16 gate, and in f32 at 2 layers phase 7's greedy tokens and its
   logits within ``F32_LOGITS_TOL``; (c) phase 18 (b) with
   ``act_shard="seq_model"`` (the EP under sequence parallelism), its
   gates; (d) the dry-run's collective bytes of stablelm-1.6b
   ``train_4k`` and codeqwen1.5-7b ``prefill_32k`` on pod16x16,
   tensor-parallel beside the whole-weight path, printed; and of one
   production cell a family of audio, ssm and hybrid (whisper-large-v3
   and zamba2-7b ``prefill_32k`` under ``seq_model``, xlstm-1.3b
   ``train_4k``).
20. The ``model`` axis computing for audio, ssm and hybrid, on a one-rank
   NCCL group over a (1, 1) mesh: (a) whisper-large-v3, zamba2-7b and
   xlstm-1.3b at full size in bf16, placed by the inference specs, at
   phases 13, 15 and 16's batch and prompts, 8 greedy tokens (the caches
   placed by ``cache_pspec``), tensor-parallel beside the same placed
   model's whole-weight path: 96 and 13 tensor-core flash launches a
   prefill and nothing else, phase 7's bf16 gate, and in f32 at 2, 7 and
   8 layers greedy tokens and last-position logits equal to the
   whole-weight path's within 1e-6; (b) zamba2-7b's ``TrainLoop(..., mesh=)`` at full
   width cut to one superblock, tensor-parallel: its first loss within
   1e-4 relative of the unplaced loop's, and in f32 at 2 and 7 layers
   the placed loss within 1e-6 of ``loss_fn``'s.
21. One JSON line describing each ported kernel, then the result line.

It imports the port, torch, numpy and the standard library only, and
exits non-zero without a result when CUDA is absent or the port is not
beside it.
"""

from __future__ import annotations

import argparse
import atexit
import concurrent.futures
import dataclasses
import json
import os
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
DECODE_SOURCE = ("src/repro_torch/kernels/decode_attention/csrc/"
                 "decode_attention.cu")
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
#: the tensor cores' wide kernel's instantiations: (owners, 64-column
#: regions an owner, q.k in rounds)
WIDE_INSTANTIATIONS = ((1, 3, 0), (1, 4, 0), (3, 2, 0), (4, 2, 0), (3, 2, 1))
#: head_dims past 128 at which phase 1 prints the tensor-core wide
#: kernel's shared memory a block
WIDE_HEAD_DIMS = (144, 160, 192, 208, 240, 256, 272, 384, 400, 512, 528,
                  576, 1024)


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


#: traces a profile takes before it fails, where the profiler has dropped a
#: window's device events (seen once on an H100 80GB HBM3: the s-step
#: kernel's trace held none of its launches)
PROFILE_ATTEMPTS = 3


def profiled(torch, fn: Callable[[], object]) -> tuple[dict, float]:
    """Run ``fn`` under ``torch.profiler``; print the device's busy time by
    kernel and its share of the wall time, and return the busy time by
    kernel name (us, launches) and the busy share.  A trace that holds no
    device operation at all (the profiler has dropped the window's device
    events) is taken again, ``PROFILE_ATTEMPTS`` times in all, then
    fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        by_kernel: dict = {}
        for e in prof.events():
            # NCCL's "nccl:<op>" ranges sit on the device's timeline over
            # its kernels: counted, they would count those kernels twice
            if e.device_type == DeviceType.CUDA and not e.name.startswith(
                    "nccl:"):
                t, n = by_kernel.get(e.name, (0.0, 0))
                by_kernel[e.name] = (t + e.time_range.elapsed_us(), n + 1)
        if by_kernel:
            break
        print(f"profile: trace {attempt} of {PROFILE_ATTEMPTS} holds no "
              f"device operation")
    else:
        raise AssertionError(f"the profiler recorded no device operation "
                             f"in {PROFILE_ATTEMPTS} traces")
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


def device_work(torch, fn: Callable[[], object], kernel: str,
                reps: int = 10) -> dict:
    """Under ``torch.profiler``, over ``reps`` calls of ``fn``: the device
    operations (kernels, memsets, copies) of one call and the device time
    of one call, in all, by operation name and of the operations whose
    name holds ``kernel`` (ms).  A trace that holds no such operation (the
    profiler has dropped a whole window of device events on this card) is
    taken again, ``PROFILE_ATTEMPTS`` times in all, then fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
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
        kernel_ms = sum(ms for op, ms in by_name.items() if kernel in op)
        if kernel_ms > 0:
            return {"ops": n_ops / reps, "ms": sum(by_name.values()),
                    "by_name": by_name, "kernel_ms": kernel_ms}
        print(f"device_work: trace {attempt} of {PROFILE_ATTEMPTS} holds "
              f"no {kernel} ({n_ops} device operations)")
    raise AssertionError(f"the profiler recorded no {kernel} in "
                         f"{PROFILE_ATTEMPTS} traces")


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
#: head_dims past the first four, in both dtypes (bf16 takes the
#: tensor-core kernel, f32 the split-TF32 one): 48, 80, 96 and 112
#: (zamba2-7b's) by their own instantiations, 40 and 72 zero-padded to 48
#: and 80; past 128, one block a q tile holding every output column (the
#: tensor cores' wide kernel with one warpgroup, split TF32's own
#: instantiations), 144, 160, 176, 192, 224, 240 and 256, and 200
#: zero-padded to 208; ragged 130, Lq < Lk, and GQA 8/2 at 112 and 256
FLASH_ANY_D = [(1, 2, 2, 130, 130, d)
               for d in (40, 48, 72, 80, 96, 112, 144, 160, 176, 192, 200,
                         224, 240, 256)] \
    + [(1, 2, 2, 70, 200, 112), (2, 8, 2, 100, 100, 112),
       (1, 2, 2, 70, 200, 256), (2, 8, 2, 100, 100, 256)]
#: bf16 only, the tensor-core kernel at every head_dim but 64 and 128:
#: its instantiations at 16, 32, 48, 80, 96 and 112 and zero-padded 40, 72
#: and 100; past 128 its wide kernel, one block a q tile holding every
#: output column, at 144, 160, 192, 208, 240 and 256 (one warpgroup of 3
#: or 4 regions) and 272, 384, 400 and 512 (owners of 128 columns, 272 and
#: 400 with a last owner of 16 or 80), past 512 in chunks of at most 384
#: columns at 528, 576 and 1,024 (q.k in rounds, q read with K), and
#: zero-padded 200; each ragged with Lq < Lk under GQA 4/2 and over three
#: q tiles (five kv tiles past 128) under MQA 8/1
FLASH_TC_ANY_D = [shape for d in (16, 32, 40, 48, 72, 80, 96, 100, 112, 144,
                                  160, 192, 200, 208, 240, 256, 272, 384,
                                  400, 512, 528, 576, 1024)
                  for shape in ((1, 4, 2, 70, 200, d), (2, 8, 1, 300, 300, d))]
#: f32 only, the split-TF32 kernel's wide kernel past head_dim 256 (32 q
#: rows a block): 272 and 400 (a last owner of 16 and 80 columns), 384,
#: 512, and past 512 in chunks at 528, 576 and 1,024, ragged 130; and at
#: 400 and 512 with Lq < Lk under GQA 8/2
FLASH_F32_PAST_256 = [(1, 2, 2, 130, 130, d)
                      for d in (272, 384, 400, 512, 528, 576, 1024)] \
    + [(2, 8, 2, 70, 200, 400), (2, 8, 2, 70, 200, 512)]
#: past head_dim 128, in both dtypes: two launches on the same inputs give
#: the same bits (the owners of a q tile add their partial scores in a
#: fixed order)
FLASH_BITWISE = [(2, 4, 2, 150, 333, d) for d in (144, 256, 400, 512, 528)]
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
        self.bitwise = {r: 0 for r in ops.ROUTES}
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

    def same_bits(self, q, k, v, causal: bool) -> None:
        """Two launches on the same inputs give the same bits."""
        which = self.ops.route(q.dtype, q.shape[-1])
        first = self.ops.flash_attention(q, k, v, causal=causal)
        second = self.ops.flash_attention(q, k, v, causal=causal)
        self.torch.cuda.synchronize()
        if not self.torch.equal(first, second):
            raise AssertionError(
                f"flash_attention ({which}) {q.dtype} causal={causal} q "
                f"{tuple(q.shape)}: two launches differ")
        self.bitwise[which] += 1

    def max_abs_err(self, which: str) -> float:
        return max(e for (r, _), e in self.max_err.items() if r == which)

    def summary(self) -> str:
        return "; ".join(
            f"{r}: {self.cases[r]} cases, max abs err " + ", ".join(
                f"{t} {self.max_err[r, t]:.3e}" for t in ("float32", "bfloat16"))
            + f", {self.bitwise[r]} bitwise-repeat cases"
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
    for shape in FLASH_TC_EDGES + FLASH_TC_ANY_D:
        q, k, v = random_qkv(torch, rng, *shape, torch.bfloat16)
        for causal in (True, False):
            parity.check(q, k, v, causal)
    for shape in FLASH_ANY_D:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = random_qkv(torch, rng, *shape, dtype)
            for causal in (True, False):
                parity.check(q, k, v, causal)
    for shape in FLASH_F32_PAST_256:
        q, k, v = random_qkv(torch, rng, *shape, torch.float32)
        for causal in (True, False):
            parity.check(q, k, v, causal)
    for shape in FLASH_BITWISE:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = random_qkv(torch, rng, *shape, dtype)
            for causal in (True, False):
                parity.same_bits(q, k, v, causal)
    # the model's layout: (B, S, H, D) activations viewed as (B, H, S, D),
    # on each route (the tensor-core kernel reads them through TMA maps),
    # and at zamba2-7b's head_dim
    for (s, hq, hkv, d), dtype in (((70, 4, 2, 32), torch.float32),
                                   ((300, 8, 2, 128), torch.bfloat16),
                                   ((300, 8, 8, 112), torch.bfloat16)):
        x = torch.from_numpy(rng.standard_normal((2, s, hq, d)).astype(
            np.float32)).to(DEVICE, dtype)
        kv = torch.from_numpy(rng.standard_normal((2, s, hkv, d)).astype(
            np.float32)).to(DEVICE, dtype)
        parity.check(x.transpose(1, 2), kv.transpose(1, 2),
                     kv.transpose(1, 2), True)


def sass_listing(lib_path: str) -> str:
    """A built library's SASS, by the ``cuobjdump`` of the toolkit that
    built it."""
    from repro_torch.kernels import _build

    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    return subprocess.run([str(cuobjdump), "-sass", lib_path],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout


def function_sass(sass: str, function: str) -> str:
    """The part of a SASS listing that belongs to the functions whose
    (mangled) name holds ``function``."""
    return "".join(f for f in sass.split("Function : ")[1:]
                   if function in f.split(None, 1)[0])


def sass_count(lib_path: str, opcode: str,
               function: Optional[str] = None) -> int:
    """Instructions of ``opcode`` in a built library's SASS: in all of it,
    or in the functions whose name holds ``function``."""
    sass = sass_listing(lib_path)
    if function is not None:
        sass = function_sass(sass, function)
    return len(re.findall(rf"\b{opcode}\b", sass))


def spilled_bytes(build_log: str) -> int:
    """Bytes of spill stores and loads over every kernel that ``ptxas -v``
    reports in a build log."""
    return sum(int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)",
                                          build_log))


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
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import ref as da_ref
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
    decoded = {"kernel": dict(da_ops.counts), "plain": dict(da_ref.counts)}
    peak = torch.cuda.max_memory_allocated()
    print(f"serve path counts: {counted}; decode attention: {decoded}")
    steps = cfg.n_layers * SERVE_NEW * SERVE_REQUESTS
    if decoded["kernel"]["decode_attention"] != steps \
            or any(decoded["plain"].values()):
        raise AssertionError(f"the serving run did not launch the "
                             f"decode-attention kernel once a layer a decode "
                             f"step ({steps}), or ran its plain version: "
                             f"{decoded}")
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
            "counts": counted, "decode_counts": decoded}


def logit_stats(torch, logits, ref) -> tuple:
    """(max abs diff, mean abs diff, share of equal argmax) of ``logits``
    against ``ref``, and ``ref``'s std, a batch row at a time (a moe
    prompt's full-sequence logits are 2.5 GB in bf16)."""
    mx = total = s1 = s2 = 0.0
    same = n = 0
    for a, r in zip(logits, ref):
        d = (a.float() - r.float()).abs()
        mx = max(mx, float(d.max()))
        total += float(d.sum(dtype=torch.float64))
        rf = r.double()
        s1, s2 = s1 + float(rf.sum()), s2 + float((rf * rf).sum())
        same += int((a.argmax(-1) == r.argmax(-1)).sum())
        n += d.numel()
        del d, rf
    rows = n // logits.shape[-1]
    std = ((s2 - s1 * s1 / n) / (n - 1)) ** 0.5
    return mx, total / n, same / rows, std


def routing_flips(calls: list, ref_calls: list) -> int:
    """Token-layers whose experts differ between two recorded paths."""
    return sum(int((e != er).any(dim=-1).sum())
               for (e, _, _), (er, _, _) in zip(calls, ref_calls))


def bf16_logits_gate(torch, fa_ref, cfg, model, batch: dict,
                     max_len: int, what: str, full: bool = False) -> dict:
    """The bf16 prefill logits of the kernel path against
    ``attention_impl="reference"`` on the same weights and batch: the last
    position's (``prefill``), or, with ``full``, every position's
    (``forward``).

    bf16 rounds each layer's attention output, so two correct attention
    paths end many layers later a few bf16 ulps of logit apart.  The floor
    of that noise is measured on the card by running the same model with
    the kernel's plain version (the same function in plain PyTorch) in
    the kernel's place.  The kernel path passes when its mean deviation
    from the reference path is within 1.1 times the floor's, and its
    largest within 5% of the logits' standard deviation or within 1.5
    times the floor's largest.

    A moe router is discrete: where two gates nearly tie, a path's
    rounding sends a token to other experts, and the logits then differ
    by those experts' outputs.  The gate holds moe as it holds the other
    families, with every path routing freely; the token-layers each path
    routes unlike the reference path are printed beside its deviations.
    Returns the deviations (max, mean) of both paths, the logits' std and
    the ratio of the mean deviations."""
    import contextlib
    from unittest import mock

    from repro_torch.models import attention, forward, moe, prefill

    def logits_of(c, plain_flash: bool = False):
        rec = RoutingRecorder(torch, moe)
        with contextlib.ExitStack() as stack:
            stack.enter_context(mock.patch.object(moe, "moe_route", rec))
            if plain_flash:
                stack.enter_context(mock.patch.object(
                    attention, "flash_ops", types.SimpleNamespace(
                        flash_attention=fa_ref.flash_attention)))
            out = (forward(c, model, batch) if full
                   else prefill(c, model, batch, max_len)[0])
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{what}: prefill logits are not finite")
        return out, rec

    plain_cfg = dataclasses.replace(cfg, attention_impl="reference")
    lr, rec_r = logits_of(plain_cfg)
    where = "every position's" if full else "last-position"
    dev = {}
    for name, plain_flash in (("kernel", False), ("floor", True)):
        logits, rec = logits_of(cfg, plain_flash)
        mx, mean, same, std = logit_stats(torch, logits, lr)
        dev[name] = (mx, mean, std)
        flips = (f", {routing_flips(rec.calls, rec_r.calls)} token-layers "
                 f"routed unlike it" if cfg.is_moe else "")
        print(f"{what}: bf16 {where} prefill logits, {name} path against "
              f"the reference path: max abs diff {mx:.6f} ({mx / std:.5f} "
              f"of the logits' std {std:.6f}), mean abs diff {mean:.6f}, "
              f"same argmax in {same:.4f} of positions{flips}")
        del logits
    del lr
    std = dev["floor"][2]
    ratio = (dev["kernel"][1] / dev["floor"][1] if dev["floor"][1]
             else float(dev["kernel"][1] > 0) or 1.0)
    print(f"{what}: kernel path's mean deviation {ratio:.4f}x the floor's "
          f"(gate 1.1x)")
    if dev["kernel"][1] > 1.1 * dev["floor"][1] or dev["kernel"][0] > max(
            0.05 * std, 1.5 * dev["floor"][0]):
        raise AssertionError(f"{what}: the kernel path's logits drift from "
                             f"the reference path's beyond bf16's floor")
    return {"kernel": dev["kernel"][:2], "floor": dev["floor"][:2],
            "std": std, "mean_ratio": ratio}


def serve_against_plain(torch, fa_ref, srv: dict) -> None:
    """Phase 7, bf16 part: the first request's prefill logits against
    ``attention_impl="reference"`` on the same weights (the gate of
    :func:`bf16_logits_gate`), and its greedy tokens."""
    from repro_torch.serving import ServeConfig, ServingEngine

    cfg, model = srv["cfg"], srv["model"]
    plain_cfg = dataclasses.replace(cfg, attention_impl="reference")
    max_len = SERVE_PROMPT + SERVE_NEW
    prompts = srv["requests"][0]
    batch = {"tokens": torch.as_tensor(prompts, dtype=torch.int64,
                                       device=DEVICE)}
    bf16_logits_gate(torch, fa_ref, cfg, model, batch, max_len, cfg.name)
    plain = ServingEngine(plain_cfg, model, ServeConfig(max_len=max_len),
                          device=DEVICE).generate(prompts, SERVE_NEW)
    same = plain == srv["outs"][0]
    print(f"bf16 greedy tokens, kernel against plain path: agreement "
          f"{float(same.mean()):.4f} of {plain.size}; "
          f"{int(same.all(axis=1).sum())} of {SERVE_BATCH} rows equal "
          f"throughout")


def f32_greedy_check(torch, fa_ops, prompts: np.ndarray) -> dict:
    """Phase 7, f32 part: full width cut to F32_LAYERS layers; every
    greedy token equal between kernel and plain paths.  Returns the
    launches of the split-TF32 flash kernel, the route of f32, on the
    kernel path, and that path's greedy tokens and last-position prefill
    logits."""
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
    return {"launches": launched["tf32x3"], "tokens": outs["pallas"],
            "logits": logits["pallas"]}


def flash_timing(torch, fa_ops, fa_ref, fparity: FlashParity, cfg,
                 card: str) -> dict:
    """Phase 8: each flash kernel, the plain version and SDPA at the
    prefill shape, on the model's layout ((B, S, H, D) viewed as
    (B, H, S, D)): the tensor-core route in bf16, the split-TF32 route in
    f32 (TF32 off for the plain version and SDPA); the tensor-core kernel
    also with p in fewer bf16 parts (``ops.P_PARTS``), at zamba2-7b's
    head_dim 112 and past 128 at 256 and 512 (its wide kernel); the
    split-TF32 kernel also at head_dims 112, 256 and 512 in f32.  Returns
    each timing by route, or by a key that names the head_dim."""
    from unittest import mock

    import torch.nn.functional as F

    b, h, l, d = SERVE_BATCH, cfg.n_heads, SERVE_PROMPT, cfg.head_dim
    # causal, Lq == Lk: l (l + 1) / 2 visible (row, column) pairs, each a
    # d-long dot product and a d-long weighted sum (2 FLOP a term); bytes:
    # q, k, v read once and out written once
    timing = {}
    # the prefill shape on each route, then in f32 at zamba2-7b's head_dim
    # 112, at 256 (split TF32's widest instantiation) and at 512 (its wide
    # kernel); in bf16 at
    # head_dim 112, zamba2-7b's serve path (phase 15), on the tensor cores,
    # and at 256 and 512 on their wide kernel; the bound counts the
    # function's work, once
    for dtype, peak, products, d, key in (
            (torch.bfloat16, PEAK_BF16_FLOP_PER_S, 1, d, None),
            (torch.float32, PEAK_TF32_FLOP_PER_S, TF32_SPLIT_PRODUCTS, d,
             None),
            (torch.float32, PEAK_TF32_FLOP_PER_S, TF32_SPLIT_PRODUCTS, 112,
             "tf32x3_d112"),
            (torch.float32, PEAK_TF32_FLOP_PER_S, TF32_SPLIT_PRODUCTS, 256,
             "tf32x3_d256"),
            (torch.bfloat16, PEAK_BF16_FLOP_PER_S, 1, 112,
             "tensor_core_d112"),
            (torch.float32, PEAK_TF32_FLOP_PER_S, TF32_SPLIT_PRODUCTS, 512,
             "tf32x3_d512"),
            (torch.bfloat16, PEAK_BF16_FLOP_PER_S, 1, 256,
             "tensor_core_d256"),
            (torch.bfloat16, PEAK_BF16_FLOP_PER_S, 1, 512,
             "tensor_core_d512")):
        flop = 4 * b * h * d * (l * (l + 1) // 2)
        which = fa_ops.route(dtype, d)
        rng = np.random.default_rng(1)
        q, k, v = (torch.from_numpy(rng.standard_normal((b, l, h, d)).astype(
            np.float32)).to(DEVICE, dtype).transpose(1, 2) for _ in range(3))
        fparity.check(q, k, v, True)
        plain = fa_ref.flash_attention(q, k, v)
        sdpa_err = float((F.scaled_dot_product_attention(q, k, v,
                                                         is_causal=True)
                          .float() - plain.float()).abs().max())
        # bf16: the share of outputs the kernel rounds unlike the plain
        # version (f32 attention rounded once), which the logits gates see
        rounding = (float((fa_ops.flash_attention(q, k, v) != plain)
                          .float().mean())
                    if dtype == torch.bfloat16 else None)
        del plain
        if rounding is not None and d > 128:
            # the wide kernel's rounding against the D 128 kernel's in this
            # run (the prefill shape comes first): a kv tile's P.V is summed
            # from zero and added to O in f32, as at D 128, so within 1.25x
            # of its share with three parts (chained into O, it rounded
            # 3.6x as many at D 256; PERF.md, Findings)
            shares = timing["tensor_core"]["p_parts_rounding_share"]
            limit = 1.25 * shares[3]
            print(f"flash_attention ({which}) at D {d}: {rounding:.5f} of "
                  f"its bf16 outputs round unlike the plain version's, "
                  f"limit {limit:.5f} [{card}]")
            if rounding > limit:
                raise AssertionError(f"the wide tensor-core kernel at D {d} "
                                     f"rounds {rounding:.5f} of its outputs "
                                     f"unlike the plain version, above "
                                     f"{limit:.5f}")
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
        if which == "tensor_core" and key is None:
            # the same kernel with p split into fewer bf16 parts, beside it
            # (instantiated at head_dim 64 and 128 only)
            out["p_parts_ms"], out["p_parts_rounding_share"] = {}, {}
            want = fa_ref.flash_attention(q, k, v)
            for n in range(fa_ops.P_PARTS, 0, -1):
                with mock.patch.object(fa_ops, "P_PARTS", n):
                    out["p_parts_rounding_share"][n] = float(
                        (fa_ops.flash_attention(q, k, v) != want)
                        .float().mean())
                    out["p_parts_ms"][n] = time_ms(
                        torch, lambda a=qkv: fa_ops.flash_attention(*a))
                print(f"flash_attention (tensor_core) with p in {n} bf16 "
                      f"parts: {out['p_parts_ms'][n]:.4f} ms, "
                      f"{out['p_parts_rounding_share'][n]:.5f} of its "
                      f"outputs round unlike the plain version's [{card}]")
            del want
        n_bytes = 4 * b * h * l * d * q.element_size()
        out["bound_ms"], out["bound_by"] = bound_ms(n_bytes, products * flop,
                                                    peak)
        if dtype == torch.float32 and key is None:
            # the CUDA-core design's bound: f32 FMAs at 67 TFLOP/s
            out["ffma_bound_ms"] = bound_ms(n_bytes, flop)[0]
        # past head_dim 128: the products the kernel issued in one call, as
        # it counts them (split TF32's warps where they issue each one, the
        # tensor cores' warpgroups as their tiles times the wgmma phase 1
        # found a tile; whole tiles, so the diagonal's masked half too),
        # against the q.k of the (q tile, kv tile) pairs the causal mask
        # leaves: 1.0 when every block issues q.k once a kv tile
        counted = qk_times = None
        if d > 128:
            fa_ops.counted_products(which, reset=True)
            fa_ops.flash_attention(q, k, v)
            counted = fa_ops.counted_products(which, reset=True)
            bq, bk = fa_ops._block_q(which, d), fa_ops._block_kv(which, d)
            pairs = fa_ops._tile_pairs(which, d, l, l)
            qk_times = counted[0] / (2 * b * h * pairs * bq * bk * d
                                     * products)
            print(f"flash_attention ({which}) at D {d} "
                  f"{str(dtype).split('.')[-1]}: the kernel counted "
                  f"{counted[0]:.4e} FLOP of q.k products and "
                  f"{counted[1]:.4e} of P.V in a call, "
                  f"{sum(counted) / flop:.4f} x the function's {flop:.4e}; "
                  f"q.k {qk_times:.4f} time(s) a "
                  f"(q tile, kv tile) pair of {bq} x {bk}"
                  + (f" in {TF32_SPLIT_PRODUCTS} TF32 products"
                     if products > 1 else "")
                  + f"; {sum(counted) / out['ms'] / 1e9:.1f} TFLOP/s of "
                  f"counted products [{card}]")
        out.update(shape=[b, h, l, l, d], flop=flop, bytes=n_bytes,
                   dtype=str(dtype).split(".")[-1], rounding_share=rounding,
                   tflop_s=flop / out["ms"] / 1e9,
                   counted_qk_flop=counted and counted[0],
                   counted_pv_flop=counted and counted[1],
                   qk_per_tile_pair=qk_times,
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
                 if "ffma_bound_ms" in out else "")
              + (f"; {rounding:.5f} of its bf16 outputs round unlike the "
                 f"plain version's" if rounding is not None else "")
              + f" [{card}]")
        timing[key or which] = out
        del q, k, v, qkv
    return timing


#: decode attention's timed shapes (name, B, H, Lmax, valid) at head_dim
#: 128 in bfloat16: the benchmark's decode batch (64 rows of 1,024 + 128
#: tokens in a 1,152-slot cache, at the mean of its valid lengths) and
#: phase 6's batch 4 (2,048 + 32 tokens, at the mean)
DECODE_SHAPES = (("decode_batch", 64, 32, 1152, 1088),
                 ("batch4", 4, 32, 2080, 2064))
DECODE_HEAD_DIM = 128
#: the H100's L2 (NVIDIA's data sheet): the timed launches rotate over
#: caches that together hold at least four times it, so that each launch
#: reads its cache from device memory
L2_BYTES = 50e6
#: launches a CUDA-event timing spans, and the timings a median is of
DECODE_LAUNCHES, DECODE_REPS = 60, 7


def events_ms(torch, fn: Callable[[int], object], launches: int,
              reps: int) -> float:
    """Median over ``reps`` of the CUDA-event time of ``launches`` calls
    ``fn(i)``, a call."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(launches):
            fn(i)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def decode_timing(torch, da_ops, da_ref, card: str) -> dict:
    """The decode-attention kernel at :data:`DECODE_SHAPES`, by CUDA events
    over many launches that rotate over caches larger than the L2, beside
    its bytes bound (k and v's valid rows read once at 3.35 TB/s), the
    decode step's plain path (``_reference_attention`` over the whole
    cache, as ``"reference"`` decodes), the kernel's plain version and
    PyTorch's SDPA on the cache's valid slice (a yardstick, never on the
    path).  The kernel's output is held to its plain version's within one
    bf16 rounding first.  Returns each shape's numbers by name."""
    import torch.nn.functional as F

    from repro_torch.models.attention import _reference_attention

    d, dtype = DECODE_HEAD_DIM, torch.bfloat16
    timing = {}
    for name, b, h, lmax, valid in DECODE_SHAPES:
        cache_bytes = 2 * b * lmax * h * d * 2
        n = max(1, -(-int(4 * L2_BYTES) // cache_bytes))
        gen = torch.Generator(device=DEVICE).manual_seed(30)
        qs = [torch.randn((b, 1, h, d), generator=gen, device=DEVICE)
              .to(dtype) for _ in range(n)]
        kvs = [tuple(torch.randn((b, lmax, h, d), generator=gen,
                                 device=DEVICE).to(dtype) for _ in range(2))
               for _ in range(n)]
        got = da_ops.decode_attention(qs[0], *kvs[0], valid)
        want = da_ref.decode_attention(qs[0], *kvs[0], valid)
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                                   atol=1e-5)
        rounding = float((got != want).float().mean())
        splits, rows = da_ops.plan(b * h, valid, torch.cuda
                                   .get_device_properties(0)
                                   .multi_processor_count)
        before = dict(da_ops.counts)

        def kernel(i):
            return da_ops.decode_attention(qs[i % n], *kvs[i % n], valid)

        out = {"ms": events_ms(torch, kernel, DECODE_LAUNCHES, DECODE_REPS)}
        launched = {key: da_ops.counts[key] - before[key]
                    for key in da_ops.counts}
        calls = 3 + DECODE_LAUNCHES * DECODE_REPS
        if launched != {"decode_attention": calls,
                        "merge": calls * int(splits > 1)}:
            raise AssertionError(f"decode_attention counted {launched} "
                                 f"launches over {calls} calls of "
                                 f"{splits} split(s)")
        # the device's own time, which the host's launch rate cannot hide
        # where a call is shorter than its launch
        out["device_ms"] = device_work(torch, lambda: kernel(0),
                                       "decode_attention")["kernel_ms"]
        out["plain_path_ms"] = events_ms(
            torch, lambda i: _reference_attention(
                qs[i % n], *kvs[i % n], causal=False, kv_valid=valid), 5, 3)
        out["plain_ms"] = events_ms(
            torch, lambda i: da_ref.decode_attention(qs[i % n], *kvs[i % n],
                                                     valid), 5, 3)
        out["library_ms"] = events_ms(
            torch, lambda i: F.scaled_dot_product_attention(
                qs[i % n].transpose(1, 2),
                kvs[i % n][0][:, :valid].transpose(1, 2),
                kvs[i % n][1][:, :valid].transpose(1, 2)),
            DECODE_LAUNCHES, DECODE_REPS)
        n_bytes = 2 * b * valid * h * d * 2
        out["bound_ms"] = n_bytes / HBM_BYTES_PER_S * 1e3
        out.update(shape=[b, h, lmax, valid, d], bytes=n_bytes,
                   splits=splits, split_rows=rows, caches=n,
                   bound_share=out["bound_ms"] / out["ms"],
                   tb_s=n_bytes / out["ms"] / 1e9, rounding_share=rounding)
        print(f"decode_attention at B {b} H {h} Lmax {lmax} valid {valid} "
              f"D {d} bf16 ({splits} split(s) of {rows} rows, {n} caches "
              f"rotated): kernel {out['ms']:.4f} ms ({out['tb_s']:.3f} TB/s, "
              f"{out['bound_share']:.4f} of the bound; "
              f"{out['device_ms']:.4f} ms on the device by the profiler), "
              f"bound "
              f"{out['bound_ms']:.4f} ms ({n_bytes} B at 3.35 TB/s), plain "
              f"path {out['plain_path_ms']:.4f} ms, plain version "
              f"{out['plain_ms']:.4f} ms, SDPA on the valid slice "
              f"{out['library_ms']:.4f} ms; {rounding:.5f} of its outputs "
              f"round unlike the plain version's [{card}]")
        timing[name] = out
        del qs, kvs, got, want
        torch.cuda.empty_cache()
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
    every tenant mining on the card, beside the baseline; the same run on
    the CPU is :func:`cluster_cpu_check`'s."""
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
    agg = run["agg"]
    print(f"cluster: {CLUSTER_SHARDS} shards, {CLUSTER_TENANTS} tenants x "
          f"{CLUSTER_TX} TPC-C transactions a stage ({run['sessions'][0]} "
          f"sessions, {run['items'][0]} items in tenant 0's log); stage 2: "
          f"{len(lats)} reads, hit rate {agg.hit_rate:.4f}, mean "
          f"{mean_us:.2f} us, p99 {core.percentile(lats, 99.0) * 1e6:.2f} us "
          f"against the baseline's {base_us:.2f} us, p99 "
          f"{core.percentile(base_lats, 99.0) * 1e6:.2f} us (virtual clock); "
          f"{len(run['patterns'])} row and {len(run['col_patterns'])} column "
          f"patterns exchanged")
    print(f"cluster walls: stage 1 {run['stage1_s']:.2f} s, mine_all "
          f"{run['mine_s']:.2f} s on the card ({launches} frontier launches, "
          f"0 plain), stage 2 {run['stage2_s']:.2f} s [{card}]")
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
            "busy_share": busy, "warm_mine_ms": warm_ms,
            "compared": {k: run[k] for k in CLUSTER_COMPARED}}


#: what the card's cluster run and the CPU's must give alike
CLUSTER_COMPARED = ("lats", "agg", "per_shard", "patterns", "col_patterns")

_CLUSTER_CPU = r"""
import pickle, sys
import torch
import chip_smoke
from repro_torch import core
from repro_torch.kernels.bitmap_support import ops, ref
torch.set_num_threads(int(sys.argv[4]))
(chip_smoke.CLUSTER_SHARDS, chip_smoke.CLUSTER_TENANTS,
 chip_smoke.CLUSTER_TX) = map(int, sys.argv[1:4])
run = chip_smoke.cluster_run(torch, core, ops, ref, "cpu")
sys.stdout.buffer.write(pickle.dumps(
    {k: run[k] for k in (*chip_smoke.CLUSTER_COMPARED, "mine_s")}))
"""
#: the CPU run's torch threads, beside the card's phases on the host
CLUSTER_CPU_THREADS = 4


def in_background(proc: subprocess.Popen) -> subprocess.Popen:
    """``proc``, killed when this script exits if it still runs."""
    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()

    atexit.register(stop)
    return proc


def cluster_cpu_start() -> subprocess.Popen:
    """Phase 10's run on the CPU (``cluster_run`` on ``"cpu"``), in a
    process of its own from before phase 9: minutes of the host's time,
    spent beside the card's phases; :func:`cluster_cpu_check` reads it."""
    return subprocess.Popen(
        [sys.executable, "-c", _CLUSTER_CPU, str(CLUSTER_SHARDS),
         str(CLUSTER_TENANTS), str(CLUSTER_TX), str(CLUSTER_CPU_THREADS)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=REPO,
        env={**os.environ,
             "PYTHONPATH": os.pathsep.join((str(REPO), str(REPO / "src")))})


def cluster_cpu_check(proc: subprocess.Popen, cluster: dict,
                      card: str) -> None:
    """Phase 10, its CPU half: the same cluster run with every tenant
    mining on the CPU gives the card's latencies, statistics, per-shard
    statistics and patterns; its ``mine_all`` wall goes into
    ``cluster["cpu_mine_s"]``."""
    import pickle

    stdout, stderr = proc.communicate(timeout=1200)
    if proc.returncode != 0:
        raise AssertionError(f"cluster (CPU): the run failed: "
                             f"{stderr.decode()[-3000:]}")
    cpu = pickle.loads(stdout)
    for key in CLUSTER_COMPARED:
        if cpu[key] != cluster["compared"][key]:
            raise AssertionError(f"the cluster on the CPU differs from the "
                                 f"card's in {key}")
    cluster["cpu_mine_s"] = cpu["mine_s"]
    print(f"cluster (CPU, beside phases 9-20 in a process of its own): "
          f"equal to the card's run in latencies, statistics, per-shard "
          f"statistics and patterns; mine_all {cpu['mine_s']:.2f} s on the "
          f"CPU against {cluster['mine_s']:.2f} s on the card [{card}]")


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
# the vlm, audio and moe families
# ---------------------------------------------------------------------------


#: the f32 check of each family at full width, cut to this depth (whisper:
#: this many encoder and decoder layers)
F32_FAMILY_LAYERS = 2


@dataclasses.dataclass(frozen=True)
class FamilyPhase:
    """One family served at full width on the card through the
    reference's model API (``make_batch``, ``prefill``, ``decode_step``)."""
    name: str
    arch: str
    seq_len: int            # make_batch's seq_len (vlm: patches + tokens)
    launches: int           # flash launches a prefill
    per_layer: int = 1      # flash launches a (decoder) layer
    layers: Optional[int] = None    # the depth cut; None: full depth
    f32_layers: int = F32_FAMILY_LAYERS     # the f32 check's depth


#: llava-next-mistral-7b at full depth: 1,152 patches + 896 tokens a row;
#: whisper-large-v3 at full depth (32 + 32 layers): a 416-token prompt
#: over 1,500 frames (416 + 32 = whisper's 448-token decoder context),
#: three flash launches a decoder layer's worth (encoder, self, cross);
#: qwen3-moe-235b-a22b at full width cut to 8 of its 94 layers (5 GB of
#: bf16 weights a layer: one 80 GB card holds about 15)
FAMILY_PHASES = (
    FamilyPhase("vlm", "llava-next-mistral-7b", 2048, 32),
    FamilyPhase("audio", "whisper-large-v3", 416, 96, per_layer=3),
    FamilyPhase("moe", "qwen3-moe-235b-a22b", 2048, 8, layers=8),
)
FAMILY_BATCH, FAMILY_NEW = 4, 32
#: f32 full-sequence logits, kernel path against plain path: the
#: split-TF32 route carries about 2^-21 of relative error a product, which
#: gave codeqwen's 2-layer last-position logits (std about 1) 7.773e-05;
#: 1e-3 leaves room for the longest sequence's tail and stays 100 times
#: below what a wrong attention output gives
F32_LOGITS_TOL = 1e-3
#: a moe token may change experts between two correct paths only where
#: its k-th and (k+1)-th gates tie within their f32 difference: a gap in
#: gate probability below this (typical gaps at 128 experts are about 4e-4)
NEAR_TIE = 1e-5


def flash_uses(cfg, per_layer: int = 1) -> int:
    """Flash-attention calls of one full-sequence pass of ``cfg``: none
    for ssm, one a use of the shared block for hybrid, ``per_layer`` a
    layer for the others."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return per_layer * cfg.n_layers


def family_cfg(spec: FamilyPhase, **overrides):
    from repro_torch import configs

    cfg = configs.get_config(spec.arch)
    cut = {"n_layers": spec.layers} if spec.layers else {}
    return dataclasses.replace(cfg, attention_impl="pallas",
                               **{**cut, **overrides})


def greedy_on_card(torch, cfg, model, batch: dict, new: int, max_len: int):
    """``prefill`` then ``new`` greedy ``decode_step``s, as the serving
    engine times them; returns the tokens (B, new) and the prefill and
    decode seconds, each ended by a synchronize."""
    from repro_torch.models import decode_step, prefill

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(cfg, model, batch, max_len)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    toks = []
    for _ in range(new):
        tok = torch.argmax(logits[:, -1, :].float(), dim=-1, keepdim=True)
        toks.append(tok)
        logits, cache = decode_step(cfg, model, cache, tok)
    out = torch.cat(toks, dim=1).cpu().numpy()
    torch.cuda.synchronize()
    return out, t1 - t0, time.perf_counter() - t1


class RoutingRecorder:
    """Wraps ``models.moe.moe_route`` and keeps, for each call, each
    token's experts (sorted), their kept mask (B, S, k) and the gap between
    the k-th and (k+1)-th gates (B, S) in ``calls``."""

    def __init__(self, torch, moe):
        self.torch, self.calls, self._route = torch, [], moe.moe_route

    def __call__(self, p, cfg, x, capacity, router=None):
        torch = self.torch
        b, s, _ = x.shape
        k = cfg.experts_per_token
        topv, ef, keep, slot = self._route(p, cfg, x, capacity,
                                           router=router)
        router = p["router"] if router is None else router
        gates = torch.softmax(x.float() @ router.float(), dim=-1)
        top = torch.topk(gates, k + 1, dim=-1).values
        # by expert, not by rank: two of a token's top k may swap ranks
        experts, order = ef.reshape(b, s, k).sort(dim=-1)
        self.calls.append((experts,
                           torch.gather(keep.reshape(b, s, k), -1, order),
                           top[..., k - 1] - top[..., k]))
        return topv, ef, keep, slot


def rerouted_rows(torch, kernel: list, plain: list, what: str):
    """Batch rows whose routing differs between the two paths in some
    layer.  A token may change experts only at a near tie of its gates
    (``NEAR_TIE``); a kept choice may change only in a row where a token
    changed experts (the capacity's positions shift after it)."""
    rows = None
    flips = 0
    for (ek, kk, gk), (ep, kp, gp) in zip(kernel, plain):
        moved = (ek != ep).any(dim=-1)                           # (B, S)
        flips += int(moved.sum())
        if bool((torch.minimum(gk, gp)[moved] >= NEAR_TIE).any()):
            raise AssertionError(f"{what}: a token changed experts between "
                                 f"the kernel and plain paths without a "
                                 f"near tie of its gates")
        row_moved = moved.any(dim=-1)
        if bool(((kk != kp).any(dim=-1).any(dim=-1) & ~row_moved).any()):
            raise AssertionError(f"{what}: kept choices differ in a row "
                                 f"where no token changed experts")
        rows = row_moved if rows is None else rows | row_moved
    return rows, flips


def f32_family_check(torch, fa_ops, spec: FamilyPhase) -> dict:
    """Full width cut to ``spec.f32_layers`` layers in f32 (the
    split-TF32 route): the full-sequence logits of the kernel and plain
    paths within ``F32_LOGITS_TOL``, and their greedy tokens equal.  For
    moe, rows where a near tie of two gates sent a token to another
    expert in one path are left out of both, and counted."""
    from unittest import mock

    from repro_torch.models import forward, init_params, make_batch, moe

    cut = {"n_layers": spec.f32_layers, "dtype": "float32"}
    if spec.name == "audio":
        cut["encoder_layers"] = spec.f32_layers
    cfg = family_cfg(spec, **cut)
    model = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                        device=DEVICE)
    batch = make_batch(cfg, FAMILY_BATCH, spec.seq_len, seed=0,
                       device=DEVICE)
    max_len = spec.seq_len + FAMILY_NEW
    per_pass = flash_uses(cfg, spec.per_layer)
    logits, outs, routes = {}, {}, {}
    reset_counts(fa_ops.counts)
    for impl in ("pallas", "reference"):
        c = dataclasses.replace(cfg, attention_impl=impl)
        rec = RoutingRecorder(torch, moe)
        with mock.patch.object(moe, "moe_route", rec):
            logits[impl] = forward(c, model, batch)
        routes[impl] = rec.calls
        outs[impl] = greedy_on_card(torch, c, model, batch, FAMILY_NEW,
                                    max_len)[0]
    launched = dict(fa_ops.counts)
    if launched != {"flash_attention": 2 * per_pass, "tensor_core": 0,
                    "tf32x3": 2 * per_pass}:
        raise AssertionError(f"{spec.name} f32: the kernel path did not "
                             f"launch the split-TF32 flash kernel "
                             f"{per_pass} times in each of its 2 passes: "
                             f"{launched}")
    b = FAMILY_BATCH
    clean = torch.ones(b, dtype=torch.bool, device=DEVICE)
    flips = 0
    if cfg.is_moe:
        moved, flips = rerouted_rows(torch, routes["pallas"],
                                     routes["reference"], spec.name)
        clean = ~moved
    n_clean = int(clean.sum())
    if n_clean == 0:
        raise AssertionError(f"{spec.name} f32: every row was rerouted")
    diff = float((logits["pallas"][clean] - logits["reference"][clean])
                 .abs().max())
    keep = clean.cpu().numpy()
    same = outs["pallas"][keep] == outs["reference"][keep]
    all_same = int((outs["pallas"] == outs["reference"]).sum())
    print(f"{spec.name} f32, {spec.f32_layers} layers at full width: "
          f"full-sequence logits {tuple(logits['pallas'].shape)} max abs diff "
          f"{diff:.3e} (tol {F32_LOGITS_TOL:g}) over {n_clean} of {b} rows"
          + (f" ({flips} token-layers routed to other experts at near ties; "
             f"those rows left out)" if cfg.is_moe else "")
          + f"; greedy tokens equal {int(same.sum())} of {same.size} "
          f"({all_same} of {outs['pallas'].size} over all rows); "
          f"{launched['tf32x3']} split-TF32 launches")
    if diff > F32_LOGITS_TOL:
        raise AssertionError(f"{spec.name} f32: logits differ between the "
                             f"kernel and plain paths by {diff:.3e}")
    if not same.all():
        raise AssertionError(f"{spec.name} f32: greedy tokens differ between "
                             f"the kernel and plain paths")
    return {"logits_max_abs_diff": diff, "launches": launched["tf32x3"],
            "rows_checked": n_clean, "routing_flips": flips}


def family_phase(torch, fa_ops, fa_ref, count_tables, spec: FamilyPhase,
                 card: str) -> dict:
    """Phases 12-14: one family at full width (moe cut in depth) in bf16,
    random weights from seed 0 made on the card, ``attention_impl=
    "pallas"``: ``make_batch``, ``prefill`` and ``FAMILY_NEW`` greedy
    ``decode_step``s.  Each prefill layer launches the tensor-core flash
    kernel (``spec.launches`` a prefill), never the split-TF32 one or the
    plain version; the bf16 logits meet phase 7's gate; the f32 check at
    cut depth holds (:func:`f32_family_check`)."""
    from repro_torch import configs
    from repro_torch.models import decode_step, init_params, make_batch, \
        prefill

    t_phase = time.perf_counter()
    cfg = family_cfg(spec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                        device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    batch = make_batch(cfg, FAMILY_BATCH, spec.seq_len, seed=0,
                       device=DEVICE)
    max_len = spec.seq_len + FAMILY_NEW
    extra = {k: tuple(v.shape) for k, v in batch.items() if k != "tokens"}
    print(f"{spec.name}: {cfg.name} at full width, {cfg.n_layers} layers"
          + (f" (cut from {configs.get_config(spec.arch).n_layers})"
             if spec.layers else "")
          + (f" + {cfg.encoder_layers} encoder layers"
             if cfg.encoder_layers else "")
          + f" (d_model {cfg.d_model}, {cfg.n_heads} q / {cfg.n_kv_heads} kv "
          f"heads x {cfg.head_dim}, d_ff {cfg.d_ff}"
          + (f", {cfg.n_experts} experts top-{cfg.experts_per_token}"
             if cfg.is_moe else "")
          + f", vocab {cfg.vocab_size}), {cfg.dtype}: {n_params} weights "
          f"made on the card from seed 0 in {init_s:.2f} s; batch "
          f"{FAMILY_BATCH} x {tuple(batch['tokens'].shape[1:])} tokens"
          + (f" + {extra}" if extra else "") + f", max_len {max_len}")

    reset_counts(*count_tables)
    out, cold_pre, cold_dec = greedy_on_card(torch, cfg, model, batch,
                                             FAMILY_NEW, max_len)
    counted = {"kernel": dict(fa_ops.counts), "plain": dict(fa_ref.counts)}
    print(f"{spec.name} path counts (one prefill, {FAMILY_NEW} decode "
          f"steps): {counted}")
    if counted["kernel"] != {"flash_attention": spec.launches,
                             "tensor_core": spec.launches, "tf32x3": 0}:
        raise AssertionError(f"{spec.name}: the prefill did not launch the "
                             f"tensor-core flash kernel, and only it, "
                             f"{spec.launches} times: {counted['kernel']}")
    if any(counted["plain"].values()):
        raise AssertionError(f"{spec.name}: the path ran the plain version")
    if out.shape != (FAMILY_BATCH, FAMILY_NEW) or not (
            (out >= 0) & (out < cfg.vocab_size)).all():
        raise AssertionError(f"{spec.name}: bad generated tokens {out.shape}")
    warm, warm_pre, warm_dec = greedy_on_card(torch, cfg, model, batch,
                                              FAMILY_NEW, max_len)
    if not np.array_equal(warm, out):
        raise AssertionError(f"{spec.name}: a second run gave other tokens")
    peak = torch.cuda.max_memory_allocated()
    tok_s = FAMILY_BATCH * FAMILY_NEW / warm_dec
    print(f"{spec.name}: prefill {cold_pre:.4f} s cold, {warm_pre:.4f} s "
          f"warm; {FAMILY_NEW} decode steps {cold_dec:.4f} s cold, "
          f"{warm_dec:.4f} s warm ({tok_s:.1f} tok/s); "
          f"max_memory_allocated {peak} B [{card}]")

    gate = bf16_logits_gate(torch, fa_ref, cfg, model, batch, max_len,
                            spec.name, full=True)
    print(f"profile of one {spec.name} prefill (warm):")
    profiled(torch, lambda: prefill(cfg, model, batch, max_len))
    cache = prefill(cfg, model, batch, max_len)[1]
    tok = torch.as_tensor(out[:, :1], dtype=torch.int64, device=DEVICE)
    print(f"profile of one {spec.name} decode step (warm, at position "
          f"{cache['pos']}):")
    profiled(torch, lambda: decode_step(cfg, model, cache, tok))
    del cache, model
    torch.cuda.empty_cache()
    f32 = f32_family_check(torch, fa_ops, spec)
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print(f"{spec.name} phase: {seconds:.1f} s")
    return {"launches": counted["kernel"]["tensor_core"],
            "prefill_s": warm_pre, "decode_s": warm_dec, "tok_s": tok_s,
            "peak_bytes": peak, "gate": gate, "f32": f32,
            "seconds": seconds, "params": n_params}


# ---------------------------------------------------------------------------
# the hybrid and ssm families
# ---------------------------------------------------------------------------

#: zamba2-7b and xlstm-1.3b at full width and depth, served as phase 6
#: serves codeqwen; the f32 checks at full width cut to 13 layers (zamba2:
#: 2 superblocks of 6 Mamba2 blocks, each followed by the shared attention
#: block, and a tail of 1) and 16 (xlstm: 2 superblocks of 7 mLSTM blocks
#: and 1 sLSTM block).  zamba2's prefill calls the shared block 13 times
#: (81 // 6), on the tensor-core route (bf16 at head_dim 112); xlstm has no
#: attention
SSM_PHASES = (
    FamilyPhase("hybrid", "zamba2-7b", SERVE_PROMPT, 13, f32_layers=13),
    FamilyPhase("ssm", "xlstm-1.3b", SERVE_PROMPT, 0, f32_layers=16),
)
#: the chunked-against-recurrent check's prompt: not a multiple of the
#: 256-position chunk, so the padding path runs
RECURRENT_PROMPT = 300
#: zamba2-7b's bf16 gate ratio with its shared attention on the split-TF32
#: kernel, before bf16 took the tensor-core route at head_dim 112 (an
#: H100 80GB HBM3 at 700 W; PERF.md): printed beside the ratio now
SPLIT_TF32_HYBRID_GATE_RATIO = 1.0524


#: a block's chunked output against its decode run token by token from
#: zero states on the same input: the reference's own tolerance for it
#: (``tests/test_ssm.py``: rtol and atol 2e-4)
BLOCK_TOL = 2e-4
#: the whole model's chunked logits against ``decode_step`` token by token
#: may differ by ``F32_LOGITS_TOL``, or, where the model's own f32
#: sensitivity is larger, by this many times the deviation that a
#: perturbation of the embedding table by one unit roundoff (2^-24,
#: relative) causes in the chunked logits.  Over 16 xlstm layers and 300
#: tokens that floor is about 1e-2 (the reference's own chunked and
#: recurrent paths differ by as much: ``tools/ssm_sensitivity.py``)
FLOOR_FACTOR = 2.0


class BlockRecorder:
    """Wraps one of ``models.ssm``'s ``*_apply`` functions and keeps each
    call's (weights, input, output) in ``calls``."""

    def __init__(self, apply):
        self.apply, self.calls = apply, []

    def __call__(self, p, cfg, x, **kw):
        y = self.apply(p, cfg, x, **kw)
        self.calls.append((p, x, y))
        return y


def block_recurrent_diffs(torch, ssm, cfg, recorded: dict) -> dict:
    """Each recorded block call's chunked output against the block's
    decode run token by token from zero states on the same input: kind ->
    (max abs diff, the largest |diff| / (atol + rtol |chunked|) at
    ``BLOCK_TOL``, blocks checked)."""
    out = {}
    for kind, rec in recorded.items():
        decode = getattr(ssm, f"{kind}_decode")
        diff = worst = 0.0
        for p, x, y in rec.calls:
            b = x.shape[0]

            def zeros(shape, dtype=torch.float32):
                return torch.zeros(shape, dtype=dtype, device=x.device)

            if kind == "mlstm":
                states = [zeros(ssm.mlstm_state_shape(cfg, b))]
            elif kind == "slstm":
                states = [tuple(zeros(ssm.slstm_state_shape(cfg, b))
                                for _ in range(3))]
            else:
                st, cv = ssm.mamba2_state_shapes(cfg, b)
                states = [zeros(st), zeros(cv, x.dtype)]
            steps = []
            for t in range(x.shape[1]):
                y_t, *states = decode(p, cfg, x[:, t:t + 1], *states)
                steps.append(y_t)
            d = (torch.cat(steps, dim=1) - y).abs()
            diff = max(diff, float(d.max()))
            worst = max(worst, float((d / (BLOCK_TOL + BLOCK_TOL * y.abs()))
                                     .max()))
        out[kind] = (diff, worst, len(rec.calls))
    return out


def recurrent_check(torch, spec: FamilyPhase) -> dict:
    """The reference's own invariant (``tests/test_ssm.py``) at full
    width, cut to ``spec.f32_layers`` layers in f32, on a
    ``RECURRENT_PROMPT``-token prompt.  Each SSM block's chunked output
    in ``forward`` against its decode run token by token from zero
    states on the same input, within ``BLOCK_TOL`` (rtol and atol, as the
    reference's test); then the whole model: ``forward``'s full-sequence
    logits (zamba2's attention on the flash kernel) against
    ``decode_step`` run token by token from ``init_cache``'s zero states
    (zamba2's shared attention decoding against its growing KV cache),
    within ``F32_LOGITS_TOL`` or ``FLOOR_FACTOR`` times the model's own
    f32 sensitivity, max and mean alike."""
    import contextlib
    from unittest import mock

    from repro_torch.models import (
        decode_step, forward, init_cache, init_params, make_batch, ssm,
    )

    cfg = family_cfg(spec, n_layers=spec.f32_layers, dtype="float32")
    if RECURRENT_PROMPT % cfg.ssm_chunk == 0:
        raise AssertionError("the recurrent check's prompt must leave a "
                             "padded chunk")
    model = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                        device=DEVICE)
    batch = make_batch(cfg, FAMILY_BATCH, RECURRENT_PROMPT, seed=0,
                       device=DEVICE)
    kinds = ("mlstm", "slstm") if cfg.family == "ssm" else ("mamba2",)
    recorded = {k: BlockRecorder(getattr(ssm, f"{k}_apply")) for k in kinds}
    with contextlib.ExitStack() as stack:
        for k, rec in recorded.items():
            stack.enter_context(mock.patch.object(ssm, f"{k}_apply", rec))
        chunked = forward(cfg, model, batch)
    if not bool(torch.isfinite(chunked).all()):
        raise AssertionError(f"{spec.name} f32: chunked logits not finite")
    blocks = block_recurrent_diffs(torch, ssm, cfg, recorded)
    del recorded
    for kind, (diff, worst, n) in blocks.items():
        print(f"{spec.name} f32: {n} {kind} blocks at full width, chunked "
              f"against {RECURRENT_PROMPT} decode steps from zero states on "
              f"the same input: max abs diff {diff:.3e}, at most {worst:.4f} "
              f"of the tolerance (rtol = atol = {BLOCK_TOL:g})")
        if worst > 1:
            raise AssertionError(f"{spec.name} f32: a {kind} block's chunked "
                                 f"and recurrent outputs differ beyond "
                                 f"{BLOCK_TOL:g}")

    # the model's own f32 sensitivity: the embeddings moved by one unit
    # roundoff
    emb = model.embed.detach().clone()
    noise = torch.randn(emb.shape, device=emb.device, generator=torch.Generator(
        device=DEVICE).manual_seed(1))
    model.embed.mul_(1 + 2.0 ** -24 * noise)
    floor = (forward(cfg, model, batch) - chunked).abs()
    model.embed.copy_(emb)
    floor_max, floor_mean = float(floor.max()), float(floor.mean())
    del floor, emb, noise

    cache = init_cache(cfg, FAMILY_BATCH, RECURRENT_PROMPT, device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    maxes, sums = [], []
    for t in range(RECURRENT_PROMPT):
        logits, cache = decode_step(cfg, model, cache,
                                    batch["tokens"][:, t:t + 1])
        d = (logits[:, 0] - chunked[:, t]).abs()
        maxes.append(d.max())
        sums.append(d.sum(dtype=torch.float64))
    diff = float(torch.stack(maxes).max())
    mean = float(torch.stack(sums).sum()) / chunked.numel()
    torch.cuda.synchronize()
    steps_s = time.perf_counter() - t0
    std = float(chunked.std())
    gate_max = max(F32_LOGITS_TOL, FLOOR_FACTOR * floor_max)
    gate_mean = max(F32_LOGITS_TOL, FLOOR_FACTOR * floor_mean)
    print(f"{spec.name} f32, {spec.f32_layers} layers at full width: "
          f"chunked full-sequence logits {tuple(chunked.shape)} against "
          f"{RECURRENT_PROMPT} decode steps from zero states: max abs diff "
          f"{diff:.3e}, mean {mean:.3e} (the logits' std {std:.4f}); the "
          f"embeddings moved by 2^-24 move the chunked logits by max "
          f"{floor_max:.3e}, mean {floor_mean:.3e}; gates max {gate_max:.3e},"
          f" mean {gate_mean:.3e}; the steps took {steps_s:.2f} s")
    if diff > gate_max or mean > gate_mean:
        raise AssertionError(f"{spec.name} f32: the chunked and recurrent "
                             f"logits differ by {diff:.3e} (mean {mean:.3e})"
                             f" beyond the model's own f32 sensitivity")
    return {"logits_max_abs_diff": diff, "logits_mean_abs_diff": mean,
            "floor_max": floor_max, "floor_mean": floor_mean, "std": std,
            "blocks": blocks}


def slstm_seconds(torch, cfg, model, batch: dict, max_len: int) -> tuple:
    """One prefill with each sLSTM block timed (a synchronize before and
    after each): (seconds in the sLSTM blocks, seconds of the prefill)."""
    from unittest import mock

    from repro_torch.models import prefill, ssm

    apply, spent = ssm.slstm_apply, []

    def timed(p, c, x, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = apply(p, c, x, **kw)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(ssm, "slstm_apply", timed):
        prefill(cfg, model, batch, max_len)
    torch.cuda.synchronize()
    return sum(spent), time.perf_counter() - t0


def ssm_phase(torch, fa_ops, fa_ref, count_tables, spec: FamilyPhase,
              card: str) -> dict:
    """Phases 15-16: one family at full width and depth in bf16, random
    weights from seed 0 made on the card, ``attention_impl="pallas"``,
    served through ``ServingEngine`` as phase 6 serves codeqwen.  Every
    prefill launches the tensor-core flash kernel ``spec.launches`` times,
    never the split-TF32 one or the plain version; zamba2's bf16 logits
    meet phase 7's gate and its f32 cut the kernel-against-plain check
    (:func:`f32_family_check`); both families hold the
    chunked-against-recurrent check (:func:`recurrent_check`)."""
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serving import ServeConfig, ServingEngine

    t_phase = time.perf_counter()
    cfg = family_cfg(spec)
    max_len = SERVE_PROMPT + SERVE_NEW
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                        device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{spec.name}: {cfg.name} at full width and depth ({cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.n_heads} heads"
          + (f", shared attention {cfg.n_heads} q / {cfg.n_kv_heads} kv "
             f"heads x {cfg.head_dim} after every {cfg.attn_every} Mamba2 "
             f"blocks, d_ff {cfg.d_ff}, ssm_state {cfg.ssm_state}"
             if cfg.family == "hybrid" else
             f", one sLSTM block after every {cfg.slstm_every - 1} mLSTM "
             f"blocks")
          + f", ssm_chunk {cfg.ssm_chunk}, vocab {cfg.vocab_size}), "
          f"{cfg.dtype}: {n_params} weights made on the card from seed 0 "
          f"in {init_s:.2f} s")
    rng = np.random.default_rng(0)
    requests = [rng.integers(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT))
                .astype(np.int32) for _ in range(SERVE_REQUESTS)]
    engine = ServingEngine(cfg, model, ServeConfig(max_len=max_len),
                           device=DEVICE)
    want = {"flash_attention": spec.launches, "tensor_core": spec.launches,
            "tf32x3": 0}
    reset_counts(*count_tables)
    outs, per_request = [], []
    for prompts in requests:
        before, stats = dict(fa_ops.counts), engine.stats
        outs.append(engine.generate(prompts, SERVE_NEW))
        after = engine.stats
        per_request.append((after["prefill_s"] - stats["prefill_s"],
                            after["decode_s"] - stats["decode_s"]))
        launched = {r: fa_ops.counts[r] - before[r] for r in before}
        if launched != want:
            raise AssertionError(f"{spec.name}: a prefill did not launch the "
                                 f"tensor-core flash kernel, and only it, "
                                 f"{spec.launches} times: {launched}")
    counted = {"kernel": dict(fa_ops.counts), "plain": dict(fa_ref.counts)}
    peak = torch.cuda.max_memory_allocated()
    print(f"{spec.name} serve path counts ({SERVE_REQUESTS} requests): "
          f"{counted}")
    if any(counted["plain"].values()):
        raise AssertionError(f"{spec.name}: the path ran the plain version")
    for out in outs:
        if out.shape != (SERVE_BATCH, SERVE_NEW) or not (
                (out >= 0) & (out < cfg.vocab_size)).all():
            raise AssertionError(f"{spec.name}: bad generated tokens "
                                 f"{out.shape}")
    for i, (pre_s, dec_s) in enumerate(per_request):
        print(f"  request {i}: prefill {pre_s:.4f} s, decode {dec_s:.4f} s "
              f"({SERVE_BATCH * SERVE_NEW / dec_s:.1f} tok/s) [{card}]")
    st = engine.stats
    print(f"{spec.name} serve totals: prefill {st['prefill_s']:.4f} s, decode "
          f"{st['decode_s']:.4f} s, {engine.tokens_per_s:.1f} tok/s; "
          f"max_memory_allocated {peak} B [{card}]")

    batch = {"tokens": torch.as_tensor(requests[0], dtype=torch.int64,
                                       device=DEVICE)}
    out = {"launches": counted["kernel"]["tensor_core"], "params": n_params,
           "prefill_s": [p for p, _ in per_request],
           "tok_s": [SERVE_BATCH * SERVE_NEW / d for _, d in per_request],
           "peak_bytes": peak}
    if cfg.family == "hybrid":
        out["gate"] = bf16_logits_gate(torch, fa_ref, cfg, model, batch,
                                       max_len, spec.name, full=True)
        print(f"{spec.name}: gate ratio {out['gate']['mean_ratio']:.4f}x on "
              f"the tensor-core kernel; {SPLIT_TF32_HYBRID_GATE_RATIO}x on "
              f"the split-TF32 kernel before (PERF.md)")
    else:
        slstm_s, pre_s = slstm_seconds(torch, cfg, model, batch, max_len)
        out["slstm_share"] = slstm_s / pre_s
        print(f"{spec.name}: the sLSTM blocks' time loops took {slstm_s:.4f} "
              f"s of a {pre_s:.4f} s prefill ({out['slstm_share']:.4f}; "
              f"each block timed between synchronizes) [{card}]")
    print(f"profile of one {spec.name} prefill (warm):")
    prof, out["prefill_busy_share"] = profiled(
        torch, lambda: prefill(cfg, model, batch, max_len))
    out["prefill_flash_ms"], n = kernel_total(prof, "flash_attention")
    print(f"  flash kernels in the prefill: {out['prefill_flash_ms']:.3f} ms "
          f"over {n} launches [{card}]")
    cache = prefill(cfg, model, batch, max_len)[1]
    tok = torch.as_tensor(outs[0][:, :1], dtype=torch.int64, device=DEVICE)
    print(f"profile of one {spec.name} decode step (warm, at position "
          f"{cache['pos']}):")
    _, out["decode_busy_share"] = profiled(
        torch, lambda: decode_step(cfg, model, cache, tok))
    del cache, model, engine
    torch.cuda.empty_cache()
    if cfg.family == "hybrid":
        out["f32"] = f32_family_check(torch, fa_ops, spec)
        torch.cuda.empty_cache()
    out["recurrent"] = recurrent_check(torch, spec)
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"{spec.name} phase: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

#: phase 17: stablelm-1.6b (the JAX trainer's default architecture,
#: hf:stabilityai/stablelm-2-1_6b) trained at full width and depth in
#: bf16 with every block recomputed (``remat="full"``, the config's
#: default), batch 4 x 2,048, with each attention a trainer can take
TRAIN_ARCH = "stablelm-1.6b"
TRAIN_BATCH, TRAIN_SEQ = 4, 2048
TRAIN_IMPLS = ("reference", "blocked")
#: timed steps after one warm-up step, on a fixed batch (memorisation, as
#: tests/test_training.py: random streams have no learnable signal)
TRAIN_STEPS = 5
#: AdamW with a warmup short enough for the loss to fall within the
#: steps taken
TRAIN_OPT = {"lr": 1e-3, "warmup_steps": 2, "total_steps": 1000}
#: (a) f32 at full width cut to 2 layers, batch 1 x 512, card against
#: CPU: the loss within 1e-5 relative; each gradient, and each weight
#: after the AdamW step, within 1e-4 of its tensor's max-abs
TRAIN_F32_LAYERS, TRAIN_F32_BATCH, TRAIN_F32_SEQ = 2, 1, 512
TRAIN_LOSS_RTOL, TRAIN_GRAD_REL = 1e-5, 1e-4
#: (b) the two attentions' first losses, bf16 at full size
TRAIN_IMPL_LOSS_RTOL = 1e-2
#: (c) checkpoint and restart at the 2-layer cut in bf16, batch 2 x 256;
#: the resumed run's losses against the uninterrupted run's: equal bit
#: for bit on an H100 (PERF.md), held within 1e-4 relative, since CUDA's
#: embedding backward may sum in another order and a bf16 ulp of one
#: weight moves the loss by about 1e-6
CKPT_LAYERS, CKPT_BATCH, CKPT_SEQ = 2, 2, 256
RESUME_LOSS_RTOL = 1e-4


def train_cfg(**overrides):
    from repro_torch import configs

    return dataclasses.replace(configs.get_config(TRAIN_ARCH), **overrides)


def worst_rel(torch, got: dict, want: dict) -> tuple[str, float]:
    """The tensor whose largest difference between ``got`` and ``want``
    (on ``got``'s device) is the largest share of its max-abs in
    ``want``, and that share."""
    worst = ("", 0.0)
    for name, w in want.items():
        g = got[name].detach().float()
        w = w.detach().float().to(g.device)
        diff = (g - w).abs()
        scale = float(w.abs().max())
        err = float(diff.max()) if diff.numel() else 0.0
        rel = err / scale if scale else (0.0 if err == 0 else float("inf"))
        if rel > worst[1]:
            worst = (name, rel)
    return worst


def train_step_recorded(torch, steps: dict, model, opt: dict, batch: dict):
    """``steps["train_step"]``, keeping the gradients it hands to AdamW;
    returns (loss, gradients by name, metrics)."""
    from unittest import mock

    from repro_torch.training import train_step as ts

    grads, update = {}, ts.adamw_update

    def record(cfg, params, g, o):
        grads.update(g)
        return update(cfg, params, g, o)

    with mock.patch.object(ts, "adamw_update", record):
        _, _, metrics = steps["train_step"](model, opt, batch)
    return float(metrics["loss"]), grads, metrics


def f32_train_check(torch) -> dict:
    """Phase 17 (a): one ``train_step`` of each attention at full width
    cut to ``TRAIN_F32_LAYERS`` layers in f32, on the card and on the
    CPU from the same weights (drawn on the CPU, copied): the losses and
    the gradients agree, and (for the first attention; the optimizer does
    not depend on it) the card's weights after its AdamW step agree with
    the CPU's AdamW applied to the card's gradients.  (Against
    the CPU run's weights the first step is ill-conditioned: it moves a
    weight by ``lr * g / (|g| + eps)``, so where the clipped gradient is
    within a few hundred ``eps`` of zero a 1e-6 difference in ``g`` moves
    the weight visibly; that comparison is printed, not held.)  On the
    card, blocked attention against the reference attention."""
    import copy

    from repro_torch.models import init_params
    from repro_torch.training.optimizer import (
        OptConfig, adamw_init, adamw_update,
    )
    from repro_torch.training.train_step import make_steps

    base = train_cfg(n_layers=TRAIN_F32_LAYERS, dtype="float32")
    weights = init_params(base, torch.Generator().manual_seed(0),
                          device="cpu")
    tokens = np.random.default_rng(0).integers(
        0, base.vocab_size, (TRAIN_F32_BATCH, TRAIN_F32_SEQ)).astype(np.int32)
    out, card_grads = {}, {}
    for impl in TRAIN_IMPLS:
        cfg = dataclasses.replace(base, attention_impl=impl)
        runs = {}
        for dev in ("cpu", DEVICE):
            model = copy.deepcopy(weights).to(dev)
            steps = make_steps(cfg, OptConfig(**TRAIN_OPT))
            opt = steps["init_opt"](model)
            t0 = time.perf_counter()
            loss, grads, _ = train_step_recorded(
                torch, steps, model, opt,
                {"tokens": torch.as_tensor(tokens, device=dev)})
            runs[dev] = (loss, grads, dict(model.named_parameters()),
                         time.perf_counter() - t0)
        (l_cpu, g_cpu, p_cpu, s_cpu), (l_card, g_card, p_card, s_card) = (
            runs["cpu"], runs[DEVICE])
        param_worst = None
        if impl == TRAIN_IMPLS[0]:
            # the CPU's AdamW on the card's gradients, from the same weights
            stepped = dict(copy.deepcopy(weights).named_parameters())
            adamw_update(OptConfig(**TRAIN_OPT), stepped,
                         {n: g.cpu() for n, g in g_card.items()},
                         adamw_init(stepped))
            param_worst = worst_rel(torch, p_card, stepped)
            del stepped
        grad_worst = worst_rel(torch, g_card, g_cpu)
        loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
        print(f"train (a) f32 {impl}, {TRAIN_F32_LAYERS} layers at full "
              f"width, batch {TRAIN_F32_BATCH} x {TRAIN_F32_SEQ}: loss card "
              f"{l_card:.7f} cpu {l_cpu:.7f} (rel {loss_rel:.3e}); worst "
              f"gradient {grad_worst[1]:.3e} of its max-abs "
              f"({grad_worst[0]}); "
              + ("" if param_worst is None else
                 f"worst weight after the card's AdamW against the CPU's on "
                 f"the card's gradients {param_worst[1]:.3e} "
                 f"({param_worst[0]}); ")
              + f"worst weight against the CPU run's "
              f"{worst_rel(torch, p_card, p_cpu)[1]:.3e} (not held); step "
              f"{s_card:.3f} s card, {s_cpu:.3f} s cpu")
        param_rel = 0.0 if param_worst is None else param_worst[1]
        if loss_rel > TRAIN_LOSS_RTOL or grad_worst[1] > TRAIN_GRAD_REL \
                or param_rel > TRAIN_GRAD_REL:
            raise AssertionError(f"train (a) {impl}: the card's train step "
                                 f"differs from the CPU's")
        out[impl] = {"loss_rel": loss_rel, "grad_rel": grad_worst[1],
                     "loss": l_card}
        if param_worst is not None:
            out[impl]["param_rel"] = param_rel
        card_grads[impl] = g_card
        del runs, g_cpu, p_cpu, p_card
    ref_loss, blk_loss = out["reference"]["loss"], out["blocked"]["loss"]
    impl_rel = abs(blk_loss - ref_loss) / abs(ref_loss)
    impl_worst = worst_rel(torch, card_grads["blocked"],
                           card_grads["reference"])
    print(f"train (a) f32 on the card, blocked against reference: loss rel "
          f"{impl_rel:.3e}, worst gradient {impl_worst[1]:.3e} of its "
          f"max-abs ({impl_worst[0]})")
    if impl_rel > TRAIN_LOSS_RTOL or impl_worst[1] > TRAIN_GRAD_REL:
        raise AssertionError("train (a): blocked and reference attention "
                             "differ on the card")
    out["blocked_vs_reference"] = {"loss_rel": impl_rel,
                                   "grad_rel": impl_worst[1]}
    return out


def train_flops(cfg, model, tokens: int) -> float:
    """Model FLOPs of one step: 6 N tokens, N the weights but the input
    embedding (a lookup; the head is a product), plus attention's 12 L B
    S^2 (H hd) (the scores and P.V, forward and backward)."""
    n = sum(p.numel() for p in model.parameters()) - model.embed.numel()
    return 6.0 * n * tokens + 12.0 * cfg.n_layers * TRAIN_BATCH \
        * TRAIN_SEQ ** 2 * cfg.n_heads * cfg.head_dim


def reference_train_flops(cfg) -> dict:
    """The reference's two counts of one train step at the card's shape,
    from the port's launch modules: ``estimate.cell_estimate`` (causal
    attention's half of S^2, 3 forwards plus one for remat) and
    ``dryrun.model_flops`` (6 N tokens, the embedding left out)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.dryrun import model_flops
    from repro_torch.launch.estimate import cell_estimate

    shape = ShapeConfig("train_card", TRAIN_SEQ, TRAIN_BATCH, "train")
    return {"estimate.cell_estimate": cell_estimate(cfg, shape)["flops"],
            "dryrun.model_flops (6 N D)": model_flops(cfg, shape)}


def train_full(torch, fa_ops, fa_ref, count_tables, impl: str, card: str,
               tmp: Path) -> dict:
    """Phase 17 (b), one attention: ``TrainLoop`` on the card at full width
    and depth in bf16, one warm-up step, then ``TRAIN_STEPS`` timed ones on
    a fixed batch, then one profiled.  Checkpoints are (c)'s: here
    ``save_now`` only records its calls (a full checkpoint is 16.5 GB)."""
    from repro_torch.launch.train import TrainLoop
    from repro_torch.training.optimizer import OptConfig

    cfg = train_cfg(attention_impl=impl)
    loop = TrainLoop(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, ckpt_dir=tmp,
                     opt_cfg=OptConfig(**TRAIN_OPT), save_every=10 ** 9,
                     device=DEVICE)
    fixed = loop.pipeline.batch_at(0)
    loop.pipeline.batch_at = lambda step: fixed
    saves, metrics, step = [], [], loop.train_step
    loop.save_now = saves.append

    def recorded(model, opt, batch):
        out = step(model, opt, batch)
        metrics.append(out[2])
        return out

    loop.train_step = recorded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loop.init_or_restore()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    model, _ = loop.state
    reset_counts(*count_tables)
    t0 = time.perf_counter()
    losses = loop.run(1, log_every=1)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    losses += loop.run(1 + TRAIN_STEPS, log_every=1)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TRAIN_STEPS
    counted = counts_now(fa_ops, fa_ref)
    peak = torch.cuda.max_memory_allocated()
    print(f"train (b) {impl} path counts ({1 + TRAIN_STEPS} steps): "
          f"{counted}")
    if any(counted["kernel"].values()) or any(counted["plain"].values()):
        raise AssertionError(f"train (b) {impl}: training called the flash "
                             f"wrapper")
    norms = [float(m["grad_norm"]) for m in metrics]
    bounds = (0.2 * np.log(cfg.vocab_size), 3 * np.log(cfg.vocab_size))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = train_flops(cfg, model, tokens)
    print(f"train (b) {impl}: losses {[round(x, 4) for x in losses]}; grad "
          f"norms {[round(x, 4) for x in norms]}; first step (warm-up) "
          f"{warm_s:.3f} s, init {init_s:.2f} s; warm {step_s:.4f} s a step, "
          f"{tokens / step_s:.1f} tokens/s; model FLOPs a step {flops:.4e} "
          f"(6 N tokens + 12 L B S^2 H hd), {flops / step_s / 1e12:.1f} "
          f"TFLOP/s, MFU {flops / step_s / PEAK_BF16_FLOP_PER_S:.4f} of "
          f"{PEAK_BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s; max_memory_allocated "
          f"{peak} B [{card}]")
    ref_flops = reference_train_flops(cfg)
    print(f"train (b) {impl}: the reference's counts of a step's FLOPs: "
          + ", ".join(f"{name} {f:.4e} (MFU {f / step_s / PEAK_BF16_FLOP_PER_S:.4f})"
                      for name, f in ref_flops.items()))
    if not bounds[0] < losses[0] < bounds[1]:
        raise AssertionError(f"train (b) {impl}: first loss {losses[0]} "
                             f"outside {bounds}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train (b) {impl}: the loss did not fall on "
                             f"the fixed batch: {losses}")
    if not all(np.isfinite(norms)):
        # the global norm is finite exactly where every gradient is
        raise AssertionError(f"train (b) {impl}: a gradient is not finite")
    if saves != [1, 1 + TRAIN_STEPS]:           # each run's last step
        raise AssertionError(f"train (b) {impl}: save_now calls {saves}")
    model, opt = loop.state
    batch = {"tokens": torch.as_tensor(fixed["tokens"], device=DEVICE)}
    print(f"profile of one {cfg.name} train step ({impl}, warm):")
    _, busy = profiled(torch, lambda: recorded(model, opt, batch))
    return {"losses": losses, "grad_norms": norms, "step_s": step_s,
            "tokens_s": tokens / step_s, "flops": flops,
            "mfu": flops / step_s / PEAK_BF16_FLOP_PER_S, "peak_bytes": peak,
            "busy_share": busy, "warmup_step_s": warm_s,
            "launches": counted["kernel"]["flash_attention"],
            "loop": loop, "batch": batch}


def trained_prefill_check(torch, fa_ops, fa_ref, count_tables, model,
                          opt: dict, batch: dict, card: str) -> dict:
    """Phase 17 (d) and (e): the trained model's ``prefill_step`` with
    ``attention_impl="pallas"`` launches the tensor-core flash kernel once
    a layer, and its last-position bf16 logits meet phase 7's gate
    against the plain route; its ``train_step`` raises on the card
    without a launch (the kernels have no backward)."""
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_step import make_steps

    cfg = train_cfg(attention_impl="pallas")
    steps = make_steps(cfg, OptConfig(**TRAIN_OPT))
    reset_counts(*count_tables)
    logits = steps["prefill_step"](model, batch)
    torch.cuda.synchronize()
    counted = counts_now(fa_ops, fa_ref)
    print(f"train (d) trained model's prefill_step counts: {counted}")
    want = cfg.n_layers
    if counted["kernel"] != {"flash_attention": want, "tensor_core": want,
                             "tf32x3": 0} or any(counted["plain"].values()):
        raise AssertionError(f"train (d): prefill_step did not launch the "
                             f"tensor-core flash kernel, and only it, "
                             f"{want} times: {counted}")
    if tuple(logits.shape) != (TRAIN_BATCH, 1, cfg.vocab_size) or not bool(
            torch.isfinite(logits.float()).all()):
        raise AssertionError(f"train (d): prefill_step logits "
                             f"{tuple(logits.shape)} not finite or shaped")
    with torch.no_grad():
        gate = bf16_logits_gate(torch, fa_ref, cfg, model, batch, TRAIN_SEQ,
                                f"{cfg.name} trained")
    reset_counts(*count_tables)
    small = {"tokens": batch["tokens"][:1, :64]}
    try:
        steps["train_step"](model, opt, small)
    except NotImplementedError as e:
        print(f"train (e) train_step with attention_impl='pallas' raised: "
              f"{e}")
    else:
        raise AssertionError("train (e): a train step through the flash "
                             "kernel did not raise")
    if any(fa_ops.counts.values()) or any(fa_ref.counts.values()):
        raise AssertionError("train (e): the raising step launched")
    return {"launches": counted["kernel"]["tensor_core"], "gate": gate}


def tensor_bits(torch, t):
    """A tensor's raw words, to compare bit for bit."""
    size = t.element_size()
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.detach().view(ints[size]) if t.is_floating_point() else t


def checkpoint_check(torch, card: str, tmp: Path) -> dict:
    """Phase 17 (c): at full width cut to ``CKPT_LAYERS`` layers in bf16:
    a run's ``save_now``, then a fresh ``TrainLoop.init_or_restore``
    bitwise equal to it, and the resumed run's next losses against the
    uninterrupted run's; ``run_with_restarts`` with a failure injected at
    step 6 of 12 (checkpoints every 4) restarts once and records 8 losses,
    as the JAX package's test.  The two runs after the restore save
    nothing (their ``save_now`` records its calls): a checkpoint here is
    5.1 GB and its save, not the step, would take the time."""
    from repro_torch.launch.train import TrainLoop, run_with_restarts
    from repro_torch.training.checkpoint import list_steps
    from repro_torch.training.optimizer import OptConfig

    cfg = train_cfg(n_layers=CKPT_LAYERS)
    tmp.mkdir(parents=True)
    usage = shutil.disk_usage(tmp)
    print(f"train (c) checkpoint directory's disk: {usage.free} B free of "
          f"{usage.total} B")

    def make_loop(sub: str, save_every: int):
        return TrainLoop(cfg, batch=CKPT_BATCH, seq=CKPT_SEQ,
                         ckpt_dir=tmp / sub, opt_cfg=OptConfig(**TRAIN_OPT),
                         save_every=save_every, device=DEVICE)

    first = make_loop("resume", 10 ** 9)
    first.init_or_restore()
    save_s, save = [], first.save_now

    def timed_save(step: int) -> None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save(step)
        save_s.append(time.perf_counter() - t0)

    first.save_now = timed_save
    first.run(2)                                # ends in save_now(2)
    step_dir = tmp / "resume" / "step_000000002"
    ckpt_bytes = sum(f.stat().st_size for f in step_dir.iterdir())
    n_leaves = len(json.loads((step_dir / "manifest.json").read_text())
                   ["names"])
    second = make_loop("resume", 10 ** 9)
    t0 = time.perf_counter()
    start = second.init_or_restore()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if start != 2:
        raise AssertionError(f"train (c): restored at step {start}")
    (m1, o1), (m2, o2) = first.state, second.state
    saved = {**{f"params.{n}": t for n, t in m1.state_dict().items()},
             **{f"opt.{k}.{n}": t for k in ("m", "v")
                for n, t in o1[k].items()}, "opt.step": o1["step"]}
    restored = {**{f"params.{n}": t for n, t in m2.state_dict().items()},
                **{f"opt.{k}.{n}": t for k in ("m", "v")
                   for n, t in o2[k].items()}, "opt.step": o2["step"]}
    if list(saved) != list(restored) or not all(
            saved[n].dtype == restored[n].dtype and saved[n].device
            == restored[n].device and torch.equal(
                tensor_bits(torch, saved[n]), tensor_bits(torch, restored[n]))
            for n in saved):
        raise AssertionError("train (c): the restored state is not bitwise "
                             "the saved one")
    del saved, restored, m1, m2, o1, o2
    unsaved = []
    first.save_now = second.save_now = unsaved.append
    uninterrupted = first.run(4)
    resumed = second.run(4)
    if unsaved != [4, 4]:
        raise AssertionError(f"train (c): save_now calls {unsaved}")
    rel = max(abs(a - b) / abs(a) for a, b in zip(uninterrupted, resumed))
    print(f"train (c) {cfg.name} at {CKPT_LAYERS} layers, bf16, batch "
          f"{CKPT_BATCH} x {CKPT_SEQ}: a checkpoint of {n_leaves} leaves is "
          f"{ckpt_bytes} B (save {save_s[0]:.2f} s, restore "
          f"{restore_s:.2f} s), restored bitwise equal; steps 2-3 "
          f"uninterrupted {uninterrupted}, resumed {resumed}: largest "
          f"relative difference {rel:.3e} (tol {RESUME_LOSS_RTOL:g}) "
          f"[{card}]")
    if rel > RESUME_LOSS_RTOL:
        raise AssertionError("train (c): the resumed run's losses differ "
                             "from the uninterrupted run's")
    del first, second
    shutil.rmtree(tmp / "resume")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    losses, restarts = run_with_restarts(lambda: make_loop("restart", 4), 12,
                                         inject_failure_at=6)
    restart_s = time.perf_counter() - t0
    kept = list_steps(tmp / "restart")
    print(f"train (c) run_with_restarts(12 steps, checkpoints every 4, "
          f"failure at step 6): {restarts} restart, {len(losses)} losses, "
          f"checkpoints kept {kept}, {restart_s:.1f} s")
    if restarts != 1 or len(losses) != 8 or kept != [4, 8, 12]:
        raise AssertionError("train (c): the supervisor did not resume from "
                             "step 4 once")
    return {"ckpt_bytes": ckpt_bytes, "save_s": save_s[0],
            "restore_s": restore_s, "resume_loss_rel": rel,
            "restart_s": restart_s}


def train_phase(torch, fa_ops, fa_ref, count_tables, card: str) -> dict:
    """Phase 17: training stablelm-1.6b on the card: (a) the f32 check at
    2 layers against the CPU, (b) ``TrainLoop`` at full width and depth in
    bf16 with each attention a trainer takes, (d)-(e) the trained model's
    ``prefill_step`` on the flash kernel and its ``train_step`` refused
    there, (c) checkpoint, resume and crash-restart at 2 layers."""
    import tempfile

    from repro_torch.training.optimizer import OptConfig

    t_phase = time.perf_counter()
    cfg = train_cfg()
    print(f"train: {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads x {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, {cfg.norm}), {cfg.dtype}, remat {cfg.remat}; "
          f"{OptConfig(**TRAIN_OPT)}")
    seconds = {}
    t0 = time.perf_counter()
    out = {"f32": f32_train_check(torch)}
    torch.cuda.empty_cache()
    seconds["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    full = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        tmp = Path(tmp)
        for impl in TRAIN_IMPLS:
            full[impl] = train_full(torch, fa_ops, fa_ref, count_tables, impl,
                                    card, tmp / impl)
            if impl != TRAIN_IMPLS[-1]:
                del full[impl]["loop"], full[impl]["batch"]
                torch.cuda.empty_cache()
        first = [full[impl]["losses"][0] for impl in TRAIN_IMPLS]
        rel = abs(first[1] - first[0]) / abs(first[0])
        print(f"train (b): first losses {dict(zip(TRAIN_IMPLS, first))}, "
              f"relative difference {rel:.3e} (tol {TRAIN_IMPL_LOSS_RTOL:g})")
        if rel > TRAIN_IMPL_LOSS_RTOL:
            raise AssertionError("train (b): the two attentions' first losses "
                                 "differ")
        last = full[TRAIN_IMPLS[-1]]
        model, opt = last.pop("loop").state
        seconds["b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["prefill"] = trained_prefill_check(
            torch, fa_ops, fa_ref, count_tables, model, opt,
            last.pop("batch"), card)
        del model, opt
        torch.cuda.empty_cache()
        seconds["d-e"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["ckpt"] = checkpoint_check(torch, card, tmp / "ckpt")
        torch.cuda.empty_cache()
        seconds["c"] = time.perf_counter() - t0
    out["full"] = full
    out["seconds"] = time.perf_counter() - t_phase
    print(f"training phase: {out['seconds']:.1f} s (" + ", ".join(
        f"({k}) {v:.1f} s" for k, v in seconds.items()) + ")")
    return out


# ---------------------------------------------------------------------------
# sharding and launch on torch.distributed
# ---------------------------------------------------------------------------

#: phase 18 (a): the sharded step's first loss against phase 17's unsharded
#: one (the same seed, batch and optimizer) and, in f32 at 2 layers, the
#: sharded loss against the plain ``loss_fn``
SHARD_STEPS = 3
SHARD_LOSS_RTOL, SHARD_F32_RTOL = 1e-4, 1e-6
SHARD_F32_BATCH, SHARD_F32_SEQ = 2, 512
#: (b) qwen3-moe-235b-a22b's EP prefill at phase 12's cut and shape; its
#: f32 check against the CPU at 2 layers on 2 x 128 tokens (the CPU's
#: expert products and unembedding stay seconds)
EP_NEW = 4
EP_F32_LAYERS, EP_F32_BATCH, EP_F32_SEQ = 2, 2, 128
#: (c) the production cells printed beside the card's
DRYRUN_ARCHS = ("stablelm-1.6b", "qwen3-moe-235b-a22b")

_DRYRUN = r"""
import json, sys
from repro_torch.configs import SHAPES, ShapeConfig, get_config
from repro_torch.launch.dryrun import run_cell
import dataclasses
arch, batch, seq, impl = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
    sys.argv[4]
cfg = dataclasses.replace(get_config(arch), attention_impl=impl)
out = {"card": run_cell(arch, ShapeConfig("train_card", seq, batch, "train"),
                        False, mesh_shape=(1, 1), cfg=cfg)}
for name in sys.argv[5].split(","):
    for shape in SHAPES:
        for multi in (False, True):
            r = run_cell(name, shape, multi, auto_opt=True)
            out[f"{name} {shape} {r['mesh']}"] = {
                k: r.get(k) for k in ("status", "memory", "reason", "error")
            } | ({"dominant": r["roofline"]["dominant"],
                  "compute_s": r["roofline"]["compute_s"],
                  "memory_s": r["roofline"]["memory_s"],
                  "collective_s": r["roofline"]["collective_s"]}
                 if r["status"] == "ok" else {})
print(json.dumps(out))
"""


def ep_clean_rows(torch, card: list, cpu: list, b: int, s: int):
    """Rows of an EP pass both paths route alike.  EP routes a rank's
    tokens as one flat sequence (row-major over the batch), so a token's
    position in its expert, and with it its kept mask, depends on every
    token before it: a row is clean when it lies wholly before the first
    token, in any layer, that changed experts at a near tie (``NEAR_TIE``);
    a kept mask may differ only after that token."""
    first = b * s
    for (ek, kk, gk), (ep, kp, gp) in zip(card, cpu):
        ek, ep = ek.reshape(b * s, -1), ep.to(ek.device).reshape(b * s, -1)
        moved = (ek != ep).any(dim=-1)
        gap = torch.minimum(gk.reshape(-1), gp.to(gk.device).reshape(-1))
        if bool((gap[moved] >= NEAR_TIE).any()):
            raise AssertionError("EP f32: a token changed experts between "
                                 "the card and the CPU without a near tie")
        kept = (kk.reshape(b * s, -1) != kp.to(kk.device).reshape(
            b * s, -1)).any(dim=-1)
        where = torch.nonzero(moved).flatten()
        f = int(where[0]) if where.numel() else b * s
        if bool(kept[:f].any()):
            raise AssertionError("EP f32: kept choices differ before any "
                                 "token changed experts")
        first = min(first, f)
    return torch.arange(b, device=DEVICE) < (first // s)


def sharded_train_check(torch, training: dict, card: str, mesh,
                        tmp: Path, label: str = "shard (a)") -> dict:
    """Phase 18 (a): ``TrainLoop(..., mesh=)`` on the one-rank NCCL mesh,
    as phase 17 (b) runs it with ``"reference"`` attention: its first
    loss against phase 17's, the step's seconds, peak memory and busy
    share, and the bytes the rank holds of parameters and moments; then
    the sharded loss in f32 at 2 layers against the plain ``loss_fn``."""
    from repro_torch.launch.train import TrainLoop
    from repro_torch.models import init_params, loss_fn, make_batch
    from repro_torch.sharding import place, rules
    from repro_torch.models.transformer import param_shapes
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_step import mesh_loss

    cfg = train_cfg(attention_impl="reference")
    loop = TrainLoop(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, ckpt_dir=tmp,
                     opt_cfg=OptConfig(**TRAIN_OPT), save_every=10 ** 9,
                     device=DEVICE, mesh=mesh)
    fixed = loop.pipeline.batch_at(0)
    loop.pipeline.batch_at = lambda step: fixed
    loop.save_now = lambda step: None        # a checkpoint is 16.5 GB
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loop.init_or_restore()
    model, opt = loop.state
    placed = {p.placements for p in model.parameters()
              if place.is_dtensor(p)}
    if len(placed) < 2 or not all(place.is_dtensor(p)
                                  for p in model.parameters()):
        raise AssertionError(f"{label}: parameters not placed: {placed}")
    held = {"params": place.local_bytes(model.parameters()),
            "opt": place.local_bytes(list(opt["m"].values())
                                     + list(opt["v"].values())
                                     + [opt["step"]])}
    t0 = time.perf_counter()
    losses = loop.run(1, log_every=1)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    losses += loop.run(SHARD_STEPS, log_every=1)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / (SHARD_STEPS - 1)
    peak = torch.cuda.max_memory_allocated()
    plain = training["full"]["reference"]
    rel = abs(losses[0] - plain["losses"][0]) / abs(plain["losses"][0])
    batch = {"tokens": torch.as_tensor(fixed["tokens"], device=DEVICE)}
    print(f"{label}: profile of one sharded {cfg.name} train step (warm):")
    _, busy = profiled(torch, lambda: loop.train_step(model, opt, batch))
    print(f"{label}: {cfg.name} TrainLoop on a (1, 1) mesh, "
          f"{len(placed)} placements; losses "
          f"{[round(x, 4) for x in losses]}; first loss {losses[0]!r} "
          f"against the unsharded loop's {plain['losses'][0]!r} (phase 17): "
          f"relative difference {rel:.3e} (tol {SHARD_LOSS_RTOL:g}); warm "
          f"{step_s:.4f} s a step against phase 17's {plain['step_s']:.4f} "
          f"s, first step {warm_s:.3f} s; busy share {busy:.4f}; "
          f"max_memory_allocated {peak} B; held by the rank: parameters "
          f"{held['params']} B, moments {held['opt']} B [{card}]")
    if rel > SHARD_LOSS_RTOL:
        raise AssertionError(f"{label}: the sharded first loss differs from "
                             "the unsharded loop's")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: the loss did not fall: {losses}")
    del loop, model, opt
    torch.cuda.empty_cache()

    f32 = train_cfg(n_layers=2, dtype="float32", attention_impl="reference")
    model = init_params(f32, torch.Generator(device=DEVICE).manual_seed(0),
                        device=DEVICE)
    batch = make_batch(f32, SHARD_F32_BATCH, SHARD_F32_SEQ, seed=0,
                       device=DEVICE)
    with torch.no_grad():
        want = float(loss_fn(f32, model, batch)[0])
        place.distribute_model(model, rules.param_specs(
            f32, param_shapes(f32), mesh), mesh)
        got = float(mesh_loss(f32, model, batch, mesh))
    f32_rel = abs(got - want) / abs(want)
    print(f"{label} f32, 2 layers at full width, batch {SHARD_F32_BATCH} x "
          f"{SHARD_F32_SEQ}: sharded loss {got!r}, plain {want!r}, relative "
          f"difference {f32_rel:.3e} (tol {SHARD_F32_RTOL:g})")
    if f32_rel > SHARD_F32_RTOL:
        raise AssertionError(f"{label} f32: the sharded loss differs")
    del model
    torch.cuda.empty_cache()
    return {"losses": losses, "loss_rel": rel, "step_s": step_s,
            "phase17_step_s": plain["step_s"], "peak_bytes": peak,
            "busy_share": busy, "held": held, "f32_loss_rel": f32_rel}


def ep_prefill_check(torch, fa_ops, fa_ref, count_tables, families: dict,
                     card: str, mesh, label: str = "shard (b)",
                     act_shard: str = "none") -> dict:
    """Phase 18 (b): qwen3-moe-235b-a22b at phase 12's cut with
    ``moe_shard="ep_infer"`` on the one-rank mesh (the weights placed by
    the inference specs), served through ``ServingEngine``: every prefill
    attention on the tensor-core flash kernel, the bf16 logits within phase
    12's gate, and in f32 at 2 layers the card's EP against the CPU's."""
    from unittest import mock

    from repro_torch.models import forward, init_params, make_batch, moe
    from repro_torch.models.transformer import param_shapes
    from repro_torch.serving import ServeConfig, ServingEngine
    from repro_torch.sharding import place, rules

    spec = next(s for s in FAMILY_PHASES if s.name == "moe")
    cfg = family_cfg(spec, moe_shard="ep_infer", act_shard=act_shard)
    moe.set_mesh(mesh)
    calls = []
    ep = moe.moe_apply_ep
    with mock.patch.object(moe, "moe_apply_ep",
                           lambda *a, **kw: calls.append(1) or ep(*a, **kw)):
        model = init_params(cfg, torch.Generator(device=DEVICE)
                            .manual_seed(0), device=DEVICE)
        place.distribute_model(model, rules.param_specs(
            cfg, param_shapes(cfg), mesh, training=False), mesh)
        prompts = make_batch(cfg, FAMILY_BATCH, spec.seq_len, seed=0,
                             device=DEVICE)["tokens"].cpu().numpy()
        engine = ServingEngine(cfg, model, ServeConfig(
            max_len=spec.seq_len + EP_NEW), device=DEVICE)
        reset_counts(*count_tables)
        engine.generate(prompts, EP_NEW)
        counted = counts_now(fa_ops, fa_ref)
        cold = engine.stats["prefill_s"]
        engine.generate(prompts, EP_NEW)
        warm = engine.stats["prefill_s"] - cold
    print(f"{label} EP path counts (one prefill, {EP_NEW} decode steps): "
          f"{counted}; moe_apply_ep calls {len(calls)}")
    if counted["kernel"] != {"flash_attention": spec.launches,
                             "tensor_core": spec.launches, "tf32x3": 0}:
        raise AssertionError(f"{label}: the EP prefill did not launch the "
                             f"tensor-core flash kernel, and only it, "
                             f"{spec.launches} times: {counted['kernel']}")
    if any(counted["plain"].values()):
        raise AssertionError(f"{label}: the EP path ran the plain version")
    if len(calls) != 2 * cfg.n_layers * (1 + EP_NEW):
        raise AssertionError(f"{label}: {len(calls)} EP calls")
    print(f"{label}: EP prefill (4 x {spec.seq_len}) {cold:.4f} s cold, "
          f"{warm:.4f} s warm, against phase 12's non-EP "
          f"{families['moe']['prefill_s']:.4f} s [{card}]")
    batch = make_batch(cfg, FAMILY_BATCH, spec.seq_len, seed=0,
                       device=DEVICE)
    t0 = time.perf_counter()
    gate = bf16_logits_gate(torch, fa_ref, cfg, model, batch,
                            spec.seq_len + EP_NEW, f"{label} moe EP", full=True)
    gate_s = time.perf_counter() - t0
    del engine, model
    torch.cuda.empty_cache()

    f32 = family_cfg(spec, moe_shard="ep_infer", n_layers=EP_F32_LAYERS,
                     dtype="float32", act_shard=act_shard)
    t0 = time.perf_counter()
    model = init_params(f32, torch.Generator(device=DEVICE).manual_seed(0),
                        device=DEVICE)
    batch = make_batch(f32, EP_F32_BATCH, EP_F32_SEQ, seed=0, device=DEVICE)
    cpu_model = init_params(f32, torch.Generator(), device="meta").to_empty(
        device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    routes, logits = {}, {}
    reset_counts(fa_ops.counts)
    for where, m, b in (("card", model, batch),
                        ("cpu", cpu_model, {k: v.cpu()
                                            for k, v in batch.items()})):
        rec = RoutingRecorder(torch, moe)
        with mock.patch.object(moe, "moe_route", rec):
            logits[where] = forward(f32, m, b).to(DEVICE)
        routes[where] = rec.calls
    launched = dict(fa_ops.counts)
    moe.set_mesh(None)
    clean = ep_clean_rows(torch, routes["card"], routes["cpu"],
                          EP_F32_BATCH, EP_F32_SEQ)
    if not bool(clean.any()):
        raise AssertionError(f"{label} f32: every row was rerouted")
    diff = float((logits["card"][clean] - logits["cpu"][clean]).abs().max())
    print(f"{label} f32 EP, {EP_F32_LAYERS} layers at full width, "
          f"{EP_F32_BATCH} x {EP_F32_SEQ}: card against CPU logits max abs "
          f"diff {diff:.3e} (tol {F32_LOGITS_TOL:g}) over {int(clean.sum())} "
          f"of {EP_F32_BATCH} rows; {launched['tf32x3']} split-TF32 "
          f"launches; the bf16 gate took {gate_s:.1f} s, the f32 check "
          f"{time.perf_counter() - t0:.1f} s")
    if diff > F32_LOGITS_TOL:
        raise AssertionError(f"{label} f32: the card's EP differs from the "
                             "CPU's")
    del model, cpu_model, logits
    torch.cuda.empty_cache()
    return {"launches": counted["kernel"]["tensor_core"], "prefill_s": warm,
            "cold_prefill_s": cold, "gate": gate,
            "f32": {"logits_max_abs_diff": diff,
                    "launches": launched["tf32x3"],
                    "rows_checked": int(clean.sum())}}


def dryrun_start() -> subprocess.Popen:
    """Phase 18 (c)'s dry-run, started in a process of its own (it starts
    a fake process group) before phase 17, while the card works:
    ``run_cell`` of (a)'s cell on a (1, 1) mesh, then the production
    cells of ``DRYRUN_ARCHS``."""
    return subprocess.Popen(
        [sys.executable, "-c", _DRYRUN, TRAIN_ARCH, str(TRAIN_BATCH),
         str(TRAIN_SEQ), "reference", ",".join(DRYRUN_ARCHS)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO / "src")})


def dryrun_check(proc: subprocess.Popen, held: dict, card: str) -> dict:
    """Phase 18 (c): the dry-run's bytes a rank of parameters and moments
    equal what (a) held, to the byte; its production cells printed."""
    stdout, stderr = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"shard (c): the dry-run failed: "
                             f"{stderr[-3000:]}")
    out = json.loads(stdout.strip().splitlines()[-1])
    mem = out.pop("card")["memory"]
    print(f"shard (c): run_cell of the card's cell on (1, 1): parameters "
          f"{mem['param_bytes_per_device']} B, moments "
          f"{mem['opt_bytes_per_device']} B a rank; the card held "
          f"{held['params']} B and {held['opt']} B")
    if (mem["param_bytes_per_device"], mem["opt_bytes_per_device"]) != (
            held["params"], held["opt"]):
        raise AssertionError("shard (c): the dry-run's bytes are not the "
                             "card's")
    for cell, r in out.items():
        if r["status"] != "ok":
            print(f"shard (c) {cell}: {r['status']} "
                  f"{r.get('reason') or r.get('error')}")
            continue
        coll = ("unavailable" if r["collective_s"] is None
                else f"{r['collective_s']:.4f} s")
        print(f"shard (c) {cell}: {r['memory']['argument_bytes_per_device']} "
              f"B of arguments a rank (parameters "
              f"{r['memory']['param_bytes_per_device']} B); compute "
              f"{r['compute_s']:.4f} s, memory {r['memory_s']:.4f} s, "
              f"collective {coll}: {r['dominant']} dominates (H100 data "
              f"sheet rates, not measured)")
    return {"card_bytes": mem, "cells": out}


def sharding_phase(torch, fa_ops, fa_ref, count_tables, training: dict,
                   families: dict, card: str, dry: subprocess.Popen) -> dict:
    """Phase 18: the sharded paths on a one-rank NCCL group started from a
    ``FileStore``, over a (1, 1) mesh: (a) the sharded train step, (b) the
    EP prefill, (c) the dry-run (``dry``, from :func:`dryrun_start`)
    against the card.  (a) and (b) run the
    whole-weight path (``tp.axis_of`` answering None: every weight
    gathered whole at its use, FSDP over both axes), which phase 19's
    tensor-parallel runs are read beside."""
    import tempfile
    from unittest import mock

    import torch.distributed as dist

    from repro_torch.launch.mesh import init_from_store, make_local_mesh
    from repro_torch.sharding import tp

    t_phase = time.perf_counter()
    seconds = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_shard_") as tmp:
        tmp = Path(tmp)
        backend = init_from_store(dist.FileStore(str(tmp / "store"), 1),
                                  0, 1, device=DEVICE)
        try:
            mesh = make_local_mesh(1, 1, device=DEVICE)
            print(f"shard: process group {backend}, mesh {mesh}; the "
                  f"whole-weight path")
            with mock.patch.object(tp, "axis_of", lambda *a: None):
                t0 = time.perf_counter()
                out = {"train": sharded_train_check(
                    torch, training, card, mesh, tmp / "ckpt")}
                seconds["a"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                out["ep"] = ep_prefill_check(torch, fa_ops, fa_ref,
                                             count_tables, families,
                                             card, mesh)
                seconds["b"] = time.perf_counter() - t0
        finally:
            dist.destroy_process_group()
    t0 = time.perf_counter()
    out["dryrun"] = dryrun_check(dry, out["train"]["held"], card)
    seconds["c, after (a)-(b)"] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_phase
    print(f"sharding phase: {out['seconds']:.1f} s (" + ", ".join(
        f"({k}) {v:.1f} s" for k, v in seconds.items()) + ")")
    return out


# ---------------------------------------------------------------------------
# tensor parallelism on the model axis
# ---------------------------------------------------------------------------

#: phase 19 (d): the production cells whose collective bytes are printed,
#: tensor-parallel beside the whole-weight path: (arch, shape, act_shard)
TP_DRYRUN_CELLS = (("stablelm-1.6b", "train_4k", None),
                   ("codeqwen1.5-7b", "prefill_32k", "seq_model"),
                   ("whisper-large-v3", "prefill_32k", "seq_model"),
                   ("zamba2-7b", "prefill_32k", "seq_model"),
                   ("xlstm-1.3b", "train_4k", None))

_TP_DRYRUN = r"""
import json, sys
from unittest import mock
from repro_torch.launch.dryrun import run_cell
from repro_torch.sharding import tp
out = {}
for cell in sys.argv[1].split(","):
    arch, shape, act = cell.split(":")
    for path in ("tp", "whole"):
        with mock.patch.object(tp, "axis_of", (lambda *a: None)
                               if path == "whole" else tp.axis_of):
            r = run_cell(arch, shape, False, impl="blocked",
                         act_shard=act or None)
        out[f"{arch} {shape} {path}"] = {
            "status": r["status"], "error": r.get("error"),
            **({k: r["roofline"][k] for k in (
                "coll_bytes_per_device", "coll_breakdown", "collective_s",
                "compute_s", "memory_s", "dominant")}
               if r["status"] == "ok" else {})}
print(json.dumps(out))
"""


def tp_dryrun_start() -> subprocess.Popen:
    """Phase 19 (d)'s dry-run, in a process of its own (it starts a fake
    process group) while phases 17-19 (a)-(c) hold the card."""
    cells = ",".join(f"{a}:{s}:{act or ''}" for a, s, act in TP_DRYRUN_CELLS)
    return subprocess.Popen(
        [sys.executable, "-c", _TP_DRYRUN, cells], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=REPO,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")})


def tp_dryrun_check(proc: subprocess.Popen) -> dict:
    """Phase 19 (d): each cell's collective bytes a rank, tensor-parallel
    and on the whole-weight path, printed; host
    arithmetic at the H100 data sheet's link rate."""
    stdout, stderr = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"tp (d): the dry-run failed: {stderr[-3000:]}")
    out = json.loads(stdout.strip().splitlines()[-1])
    for cell, r in out.items():
        if r["status"] != "ok":
            raise AssertionError(f"tp (d) {cell}: {r['status']} {r['error']}")
        if cell.endswith(" whole"):
            tp_ = out[cell[:-len("whole")] + "tp"]["coll_bytes_per_device"]
            print(f"tp (d) {cell[:-len(' whole')]}: tensor-parallel "
                  f"{tp_!r} B of collective operands a rank against the "
                  f"whole-weight path's {r['coll_bytes_per_device']!r} B "
                  f"({tp_ / r['coll_bytes_per_device']:.4f}x)")
        kinds = {k: v for k, v in r["coll_breakdown"].items()
                 if not k.startswith("_") and v}
        print(f"tp (d) {cell} on pod16x16: {r['coll_bytes_per_device']!r} B "
              f"of collective operands a rank ({kinds}); collective "
              f"{r['collective_s']!r} s, compute {r['compute_s']!r} s, "
              f"memory {r['memory_s']!r} s: {r['dominant']} dominates "
              f"(host arithmetic)")
    return out


def tp_serve_check(torch, fa_ops, fa_ref, count_tables, mesh, requests,
                   f32_serve: dict, card: str) -> dict:
    """Phase 19 (b): codeqwen1.5-7b at full width in bf16, placed by the
    inference specs on the one-rank mesh, served through ``ServingEngine``
    (``prefill`` places its cache by ``cache_pspec``; ``decode_step`` reads
    it): phase 6's requests, the tensor-core flash kernel once a layer a
    prefill and nothing else, phase 7's bf16 gate; the same requests on
    the same placed model's whole-weight path (``tp.axis_of`` answering
    None), timed beside; in f32 at 2 layers, greedy tokens equal to phase
    7's kernel path and the logits within ``F32_LOGITS_TOL``."""
    from unittest import mock

    from repro_torch import configs
    from repro_torch.models import init_params, prefill
    from repro_torch.models.transformer import param_shapes
    from repro_torch.serving import ServeConfig, ServingEngine
    from repro_torch.sharding import place, rules, tp

    cfg = dataclasses.replace(configs.get_config(SERVE_ARCH),
                              attention_impl="pallas")
    max_len = SERVE_PROMPT + SERVE_NEW
    model = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                        device=DEVICE)
    place.distribute_model(model, rules.param_specs(
        cfg, param_shapes(cfg), mesh, training=False), mesh)
    if tp.axis_of(cfg, model.parameters()) is None:
        raise AssertionError("tp (b): the placed model is not tensor-parallel")
    engine = ServingEngine(cfg, model, ServeConfig(max_len=max_len),
                           device=DEVICE)
    reset_counts(*count_tables)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    outs = [engine.generate(prompts, SERVE_NEW) for prompts in requests]
    counted = {"kernel": dict(fa_ops.counts), "plain": dict(fa_ref.counts)}
    peak = torch.cuda.max_memory_allocated()
    st = engine.stats
    batch = {"tokens": torch.as_tensor(requests[0], dtype=torch.int64,
                                       device=DEVICE)}
    cache = prefill(cfg, model, batch, max_len)[1]
    print(f"tp (b) serve path counts: {counted}; cache k {cache['k'].shape} "
          f"placed {cache['k'].placements}")
    del cache
    want = cfg.n_layers * len(requests)
    if counted["kernel"] != {"flash_attention": want, "tensor_core": want,
                             "tf32x3": 0} or any(counted["plain"].values()):
        raise AssertionError(f"tp (b): the serving run did not launch the "
                             f"tensor-core flash kernel, and only it, {want} "
                             f"times: {counted}")
    print(f"tp (b): {cfg.name} tensor-parallel on (1, 1), "
          f"{len(requests)} requests of {SERVE_BATCH} x {SERVE_PROMPT} x "
          f"{SERVE_NEW}: prefill {st['prefill_s']:.4f} s, decode "
          f"{st['decode_s']:.4f} s, {engine.tokens_per_s:.1f} tok/s; "
          f"max_memory_allocated {peak} B [{card}]")
    gate = bf16_logits_gate(torch, fa_ref, cfg, model, batch, max_len,
                            f"tp (b) {cfg.name}")
    tok_s = engine.tokens_per_s
    whole = ServingEngine(cfg, model, ServeConfig(max_len=max_len),
                          device=DEVICE)
    with mock.patch.object(tp, "axis_of", lambda *a: None):
        same = [int((whole.generate(p, SERVE_NEW) == o).sum())
                for p, o in zip(requests, outs)]
    ws, whole_tok_s = whole.stats, whole.tokens_per_s
    print(f"tp (b): the same placed model on the whole-weight path: prefill "
          f"{ws['prefill_s']:.4f} s, decode {ws['decode_s']:.4f} s, "
          f"{whole_tok_s:.1f} tok/s; greedy tokens equal to the "
          f"tensor-parallel path's {sum(same)} of {sum(o.size for o in outs)}"
          f" [{card}]")
    del engine, whole, model
    torch.cuda.empty_cache()

    f32 = dataclasses.replace(cfg, n_layers=F32_LAYERS, dtype="float32")
    model = init_params(f32, torch.Generator(device=DEVICE).manual_seed(0),
                        device=DEVICE)
    place.distribute_model(model, rules.param_specs(
        f32, param_shapes(f32), mesh, training=False), mesh)
    reset_counts(fa_ops.counts)
    logits = prefill(f32, model, batch, max_len)[0]
    tokens = ServingEngine(f32, model, ServeConfig(max_len=max_len),
                           device=DEVICE).generate(requests[0], SERVE_NEW)
    launched = dict(fa_ops.counts)
    diff = float((logits - f32_serve["logits"]).abs().max())
    same = int((tokens == f32_serve["tokens"]).sum())
    print(f"tp (b) f32, {F32_LAYERS} layers at full width: last-position "
          f"prefill logits against phase 7's kernel path max abs diff "
          f"{diff:.3e} (tol {F32_LOGITS_TOL:g}); greedy tokens equal {same} "
          f"of {tokens.size}; {launched['tf32x3']} split-TF32 launches")
    if diff > F32_LOGITS_TOL or same != tokens.size:
        raise AssertionError("tp (b) f32: the tensor-parallel path differs "
                             "from phase 7's")
    del model
    torch.cuda.empty_cache()
    return {"launches": counted["kernel"]["tensor_core"],
            "prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
            "tok_s": tok_s, "peak_bytes": peak, "gate": gate,
            "whole_weight": {"prefill_s": ws["prefill_s"],
                             "decode_s": ws["decode_s"],
                             "tok_s": whole_tok_s},
            "f32": {"launches": launched["tf32x3"],
                    "logits_max_abs_diff": diff}}


def tensor_parallel_phase(torch, fa_ops, fa_ref, count_tables,
                          training: dict, sharding: dict, families: dict,
                          requests: list, f32_serve: dict, card: str,
                          dry: subprocess.Popen) -> dict:
    """Phase 19: the ``model`` axis computing, on a one-rank NCCL group
    over a (1, 1) mesh (every collective moves nothing): (a) stablelm's
    ``TrainLoop(mesh=)`` tensor-parallel, beside phase 17's unsharded and
    phase 18's whole-weight step; (b) codeqwen served tensor-parallel;
    (c) qwen3-moe's EP prefill under sequence parallelism
    (``act_shard="seq_model"``), phase 18 (b)'s gates; (d) the dry-run's
    collective bytes of the production cells of ``TP_DRYRUN_CELLS``,
    printed, from ``dry`` (:func:`tp_dryrun_start`, started before phase
    17: its meta passes take minutes of the host's time)."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import init_from_store, make_local_mesh

    t_phase = time.perf_counter()
    seconds = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as tmp:
        tmp = Path(tmp)
        backend = init_from_store(dist.FileStore(str(tmp / "store"), 1),
                                  0, 1, device=DEVICE)
        try:
            mesh = make_local_mesh(1, 1, device=DEVICE)
            print(f"tp: process group {backend}, mesh {mesh}; the "
                  f"tensor-parallel path")
            t0 = time.perf_counter()
            out = {"train": sharded_train_check(
                torch, training, card, mesh, tmp / "ckpt",
                label="tp (a)")}
            fsdp = sharding["train"]
            print(f"tp (a): step {out['train']['step_s']:.4f} s "
                  f"(busy {out['train']['busy_share']:.4f}, peak "
                  f"{out['train']['peak_bytes']} B) against phase 18's "
                  f"whole-weight step {fsdp['step_s']:.4f} s (busy "
                  f"{fsdp['busy_share']:.4f}, peak {fsdp['peak_bytes']} "
                  f"B) and phase 17's unsharded "
                  f"{fsdp['phase17_step_s']:.4f} s [{card}]")
            seconds["a"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["serve"] = tp_serve_check(torch, fa_ops, fa_ref,
                                          count_tables, mesh, requests,
                                          f32_serve, card)
            seconds["b"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["ep"] = ep_prefill_check(
                torch, fa_ops, fa_ref, count_tables, families, card,
                mesh, label="tp (c)", act_shard="seq_model")
            seconds["c"] = time.perf_counter() - t0
        finally:
            dist.destroy_process_group()
    t0 = time.perf_counter()
    out["dryrun"] = tp_dryrun_check(dry)
    seconds["d, after (a)-(c)"] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_phase
    print(f"tensor-parallel phase: {out['seconds']:.1f} s (" + ", ".join(
        f"({k}) {v:.1f} s" for k, v in seconds.items()) + ")")
    return out


# ---------------------------------------------------------------------------
# the model axis computing for audio, ssm and hybrid
# ---------------------------------------------------------------------------

#: phase 20 (a): whisper-large-v3 at phase 13's batch and prompt, zamba2-7b
#: and xlstm-1.3b at phases 15-16's, full size in bf16, tensor-parallel
#: beside the same placed model's whole-weight path, each generating this
#: many greedy tokens (host-bound decode steps, each run of the three
#: families' paths paying for them, inside the script's time limit); the
#: f32 check over as many, at these cuts (whisper 2 + 2 layers; zamba2 a
#: superblock and a tail block; xlstm a superblock)
TP_FAMILY_SPECS = ("audio", "hybrid", "ssm")
TP_SERVE_NEW = 8
TP_F32_LAYERS = {"audio": 2, "hybrid": 7, "ssm": 8}
#: on one rank every collective is exact, so the f32 tensor-parallel path
#: computes the whole-weight path's products in the same order
TP_F32_TOL = 1e-6
#: (b) zamba2-7b's TrainLoop(mesh=) at full width, cut to one superblock
#: (6 Mamba2 blocks and the shared block), batch 2 x 2,048; its f32 loss
#: at 2 layers (the Mamba2 tail alone) and at 7 (a superblock and a tail
#: block) against the plain ``loss_fn``, batch 2 x 512
TP_TRAIN_ARCH, TP_TRAIN_LAYERS = "zamba2-7b", 6
TP_TRAIN_BATCH, TP_TRAIN_SEQ = 2, 2048
TP_TRAIN_F32_LAYERS = (2, 7)


def tp_family_spec(name: str) -> FamilyPhase:
    return next(s for s in FAMILY_PHASES + SSM_PHASES if s.name == name)


def placed_model(torch, cfg, mesh, training: bool = False):
    """``cfg``'s weights from seed 0 on the card, placed on ``mesh`` by the
    reference's specs (inference or training)."""
    from repro_torch.models import init_params
    from repro_torch.models.transformer import param_shapes
    from repro_torch.sharding import place, rules

    model = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                        device=DEVICE)
    return place.distribute_model(model, rules.param_specs(
        cfg, param_shapes(cfg), mesh, training=training), mesh)


def tp_family_serve(torch, fa_ops, fa_ref, count_tables, spec: FamilyPhase,
                    mesh, card: str) -> dict:
    """Phase 20 (a), one family: the model placed by the inference specs
    at full size in bf16, ``prefill`` (its cache placed by
    ``cache_pspec``) and greedy ``decode_step``s at its serving phase's
    batch and lengths, tensor-parallel, then the same placed model's
    whole-weight path (``tp.axis_of`` answering None) timed beside, each
    ``TP_SERVE_NEW`` greedy tokens.  Every
    prefill attention on the tensor-core flash kernel (``spec.launches``),
    never the split-TF32 one or the plain version; the bf16 gate of
    :func:`bf16_logits_gate` where the family has attention; in f32 at
    ``TP_F32_LAYERS``, greedy tokens and last-position logits equal to
    the whole-weight path's within ``TP_F32_TOL``."""
    from unittest import mock

    from repro_torch.models import decode_step, make_batch, prefill
    from repro_torch.sharding import place, tp

    audio = spec.name == "audio"
    rows, new = FAMILY_BATCH if audio else SERVE_BATCH, TP_SERVE_NEW
    label = f"tp family (a) {spec.name}"
    cfg = family_cfg(spec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = placed_model(torch, cfg, mesh)
    if tp.axis_of(cfg, model.parameters()) is None:
        raise AssertionError(f"{label}: the placed model is not "
                             f"tensor-parallel")
    batch = make_batch(cfg, rows, spec.seq_len, seed=0, device=DEVICE)
    max_len = spec.seq_len + new
    reset_counts(*count_tables)
    toks, cold_pre, _ = greedy_on_card(torch, cfg, model, batch, new,
                                       max_len)
    counted = counts_now(fa_ops, fa_ref)
    want = {"flash_attention": spec.launches, "tensor_core": spec.launches,
            "tf32x3": 0}
    if counted["kernel"] != want or any(counted["plain"].values()):
        raise AssertionError(f"{label}: the prefill did not launch the "
                             f"tensor-core flash kernel, and only it, "
                             f"{spec.launches} times: {counted}")
    warm, pre_s, dec_s = greedy_on_card(torch, cfg, model, batch, new,
                                        max_len)
    if not np.array_equal(warm, toks) or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"{label}: bad or unsteady greedy tokens")
    peak = torch.cuda.max_memory_allocated()
    cache = prefill(cfg, model, batch, max_len)[1]
    where = {k: str(v.placements) for k, v in cache.items()
             if place.is_dtensor(v)}
    tok = torch.as_tensor(toks[:, :1], dtype=torch.int64, device=DEVICE)
    print(f"{label}: profile of one decode step (warm, at position "
          f"{cache['pos']}):")
    _, busy = profiled(torch, lambda: decode_step(cfg, model, cache, tok))
    del cache
    with mock.patch.object(tp, "axis_of", lambda *a: None):
        whole, w_pre, w_dec = greedy_on_card(torch, cfg, model, batch, new,
                                             max_len)
    same = int((whole == toks).sum())
    print(f"{label}: {cfg.name} on (1, 1), {rows} x {spec.seq_len} + {new}: "
          f"tensor-parallel prefill {pre_s:.4f} s warm ({cold_pre:.4f} s "
          f"cold), decode {rows * new / dec_s:.1f} tok/s, decode busy share "
          f"{busy:.4f}, max_memory_allocated {peak} B; whole-weight path "
          f"prefill {w_pre:.4f} s, decode {rows * new / w_dec:.1f} tok/s; "
          f"bf16 greedy tokens equal {same} of {toks.size}; {counted} "
          f"[{card}]")
    print(f"{label}: the cache placed by cache_pspec: {where}")
    gate = None
    if spec.launches:
        gate = bf16_logits_gate(torch, fa_ref, cfg, model, batch, max_len,
                                label, full=True)
    del model
    torch.cuda.empty_cache()

    layers = TP_F32_LAYERS[spec.name]
    f32 = family_cfg(spec, n_layers=layers, dtype="float32",
                     **({"encoder_layers": layers} if audio else {}))
    model = placed_model(torch, f32, mesh)
    reset_counts(fa_ops.counts)
    got = {}
    for path in ("tp", "whole"):
        with mock.patch.object(tp, "axis_of", (lambda *a: None)
                               if path == "whole" else tp.axis_of):
            logits, cache = prefill(f32, model, batch, max_len)
            first, toks = logits, []
            for _ in range(new):
                toks.append(logits[:, -1].argmax(-1, keepdim=True))
                logits, cache = decode_step(f32, model, cache, toks[-1])
        got[path] = (first, torch.cat(toks, dim=1).cpu().numpy())
        del cache
    launched = dict(fa_ops.counts)
    diff = float((got["tp"][0] - got["whole"][0]).abs().max())
    same = int((got["tp"][1] == got["whole"][1]).sum())
    print(f"{label} f32, {layers} layers at full width: "
          f"tensor-parallel last-position logits against the whole-weight "
          f"path's max abs diff {diff:.3e} (tol {TP_F32_TOL:g}); greedy "
          f"tokens equal {same} of {got['tp'][1].size}; "
          f"{launched['tf32x3']} split-TF32 launches")
    if diff > TP_F32_TOL or same != got["tp"][1].size:
        raise AssertionError(f"{label} f32: the tensor-parallel path "
                             f"differs from the whole-weight path")
    del model, got
    torch.cuda.empty_cache()
    return {"launches": counted["kernel"]["tensor_core"], "prefill_s": pre_s,
            "tok_s": rows * new / dec_s, "decode_busy_share": busy,
            "peak_bytes": peak, "gate": gate, "cache": where,
            "whole_weight": {"prefill_s": w_pre, "tok_s": rows * new / w_dec},
            "f32": {"logits_max_abs_diff": diff,
                    "launches": launched["tf32x3"]}}


def tp_family_train(torch, mesh, card: str, tmp: Path) -> dict:
    """Phase 20 (b): zamba2-7b's ``TrainLoop(mesh=)`` at full width cut
    to ``TP_TRAIN_LAYERS`` in bf16, tensor-parallel (the Mamba2 mixers,
    the shared block and the vocabulary-parallel cross entropy): its first
    loss within ``SHARD_LOSS_RTOL`` of the same loop unplaced, its warm
    step's seconds, peak memory and busy share; then in f32 the placed
    loss against the plain ``loss_fn`` within ``SHARD_F32_RTOL``."""
    from repro_torch import configs
    from repro_torch.launch.train import TrainLoop
    from repro_torch.models import init_params, loss_fn, make_batch
    from repro_torch.models.transformer import param_shapes
    from repro_torch.sharding import place, rules, tp
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_step import mesh_loss

    cfg = dataclasses.replace(configs.get_config(TP_TRAIN_ARCH),
                              n_layers=TP_TRAIN_LAYERS)
    losses = {}
    for path, m in (("plain", None), ("tp", mesh)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loop = TrainLoop(cfg, batch=TP_TRAIN_BATCH, seq=TP_TRAIN_SEQ,
                         ckpt_dir=tmp / path, opt_cfg=OptConfig(**TRAIN_OPT),
                         save_every=10 ** 9, device=DEVICE, mesh=m)
        fixed = loop.pipeline.batch_at(0)
        loop.pipeline.batch_at = lambda step: fixed
        loop.save_now = lambda step: None
        loop.init_or_restore()
        model, opt = loop.state
        if m is not None and tp.axis_of(cfg, model.parameters()) is None:
            raise AssertionError("tp family (b): not tensor-parallel")
        losses[path] = loop.run(1, log_every=1)
        if m is None:
            del loop, model, opt
            torch.cuda.empty_cache()
            continue
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses[path] += loop.run(3, log_every=1)     # steps 1 and 2
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / 2
        peak = torch.cuda.max_memory_allocated()
        batch = {"tokens": torch.as_tensor(fixed["tokens"], device=DEVICE)}
        print("tp family (b): profile of one tensor-parallel train step "
              "(warm):")
        _, busy = profiled(torch, lambda: loop.train_step(model, opt, batch))
        del loop, model, opt
        torch.cuda.empty_cache()
    rel = abs(losses["tp"][0] - losses["plain"][0]) / abs(losses["plain"][0])
    print(f"tp family (b): {cfg.name} at full width, {cfg.n_layers} layers, "
          f"batch {TP_TRAIN_BATCH} x {TP_TRAIN_SEQ}, TrainLoop on (1, 1) "
          f"tensor-parallel: losses {losses['tp']}; first loss against the "
          f"unplaced loop's {losses['plain'][0]!r}: relative difference "
          f"{rel:.3e} (tol {SHARD_LOSS_RTOL:g}); warm step {step_s:.4f} s, "
          f"busy share {busy:.4f}, max_memory_allocated {peak} B [{card}]")
    if rel > SHARD_LOSS_RTOL or not losses["tp"][-1] < losses["tp"][0]:
        raise AssertionError("tp family (b): the tensor-parallel loss "
                             "differs from the unplaced loop's, or did not "
                             "fall")
    f32_rel = {}
    for layers in TP_TRAIN_F32_LAYERS:
        f32 = dataclasses.replace(cfg, n_layers=layers, dtype="float32")
        model = init_params(f32, torch.Generator(device=DEVICE)
                            .manual_seed(0), device=DEVICE)
        batch = make_batch(f32, SHARD_F32_BATCH, SHARD_F32_SEQ, seed=0,
                           device=DEVICE)
        with torch.no_grad():
            want = float(loss_fn(f32, model, batch)[0])
            place.distribute_model(model, rules.param_specs(
                f32, param_shapes(f32), mesh), mesh)
            got = float(mesh_loss(f32, model, batch, mesh))
        f32_rel[layers] = abs(got - want) / abs(want)
        print(f"tp family (b) f32, {layers} layers at full width, batch "
              f"{SHARD_F32_BATCH} x {SHARD_F32_SEQ}: tensor-parallel loss "
              f"{got!r}, plain {want!r}, relative difference "
              f"{f32_rel[layers]:.3e} (tol {SHARD_F32_RTOL:g})")
        del model
        torch.cuda.empty_cache()
        if f32_rel[layers] > SHARD_F32_RTOL:
            raise AssertionError("tp family (b) f32: the tensor-parallel "
                                 "loss differs")
    return {"losses": losses, "loss_rel": rel, "step_s": step_s,
            "peak_bytes": peak, "busy_share": busy, "f32_loss_rel": f32_rel}


def family_tp_phase(torch, fa_ops, fa_ref, count_tables, card: str) -> dict:
    """Phase 20: the ``model`` axis computing for audio, ssm and hybrid,
    on a one-rank NCCL group over a (1, 1) mesh: (a) whisper-large-v3,
    zamba2-7b and xlstm-1.3b served tensor-parallel beside their
    whole-weight path; (b) zamba2-7b's tensor-parallel train step."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import init_from_store, make_local_mesh

    t_phase = time.perf_counter()
    seconds, out = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tpf_") as tmp:
        tmp = Path(tmp)
        backend = init_from_store(dist.FileStore(str(tmp / "store"), 1), 0,
                                  1, device=DEVICE)
        try:
            mesh = make_local_mesh(1, 1, device=DEVICE)
            print(f"tp family: process group {backend}, mesh {mesh}")
            for name in TP_FAMILY_SPECS:
                t0 = time.perf_counter()
                out[name] = tp_family_serve(torch, fa_ops, fa_ref,
                                            count_tables,
                                            tp_family_spec(name), mesh, card)
                seconds[f"a {name}"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["train"] = tp_family_train(torch, mesh, card, tmp / "ckpt")
            seconds["b"] = time.perf_counter() - t0
        finally:
            dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"tensor-parallel families phase: {out['seconds']:.1f} s (" +
          ", ".join(f"({k}) {v:.1f} s" for k, v in seconds.items()) + ")")
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
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import ref as da_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    # float32 matmuls in true f32 (TF32 off, also PyTorch's default), so
    # the plain versions and the f32 serving check are exact f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    count_tables = (ops.counts, ref.counts, fa_ops.counts, fa_ref.counts,
                    da_ops.counts, da_ref.counts)

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
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        futs = {"bitmap_support": pool.submit(ops.load),
                "decode_attention": pool.submit(da_ops.load),
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
        if spilled_bytes(log or ""):
            raise AssertionError(f"{name}: ptxas spilled registers")
        if "C7520" in (log or ""):
            raise AssertionError(f"{name}: ptxas serialized wgmma (C7520)")
    print(f"kernel build + load, {len(libs)} libraries at once: "
          f"{build_s:.2f} s; each library's build: " + ", ".join(
              f"{lib} {s:.2f} s" for lib, s in _build.build_seconds.items()))
    tc = libs["tensor_core"]
    for d in (*fa_ops.TENSOR_CORE_HEAD_DIMS, *WIDE_HEAD_DIMS):
        print(f"tensor-core flash kernel at head_dim {d}: "
              f"{tc.flash_attention_wgmma_smem_bytes(d)} B of dynamic "
              f"shared memory a block"
              + (" (the wide kernel)" if d > fa_ops.TENSOR_CORE_HEAD_DIMS[-1]
                 else ""))
    # each library's blocks a q tile against the wrapper's rule, which its
    # grid checks and the CPU tests hold
    for which, blocks in (
            ("tensor_core", tc.flash_attention_wgmma_chunks),
            ("tf32x3", libs["tf32x3"].flash_attention_tf32x3_chunks)):
        differ = [d for d in range(16, 1025, 16)
                  if blocks(d) != fa_ops.out_chunks(d)]
        if differ:
            raise AssertionError(f"the {which} kernel's blocks a q tile "
                                 f"differ from ops.out_chunks at head_dims "
                                 f"{differ}")
    print("flash kernels' blocks a q tile equal ops.out_chunks at every "
          "head_dim 16-1,024, in both libraries")
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
    # the instantiations (head_dim, bf16 parts of p) on the serve paths:
    # zamba2-7b's head_dim 112 and the dense configs' 128, both 3 parts;
    # and the wide kernel of every head_dim past 128
    hgmma = {d: sass_count(tc._name, "HGMMA",
                           f"flash_attention_wgmma_kernelILi{d}ELi3E")
             for d in (112, 128)}
    hgmma["wide"] = sass_count(tc._name, "HGMMA",
                               "flash_attention_wgmma_wide_kernelILi3E")
    print("flash_attention SASS by instantiation: " + ", ".join(
        f"head_dim {d}: {n} HGMMA" for d, n in hgmma.items()))
    # the wide kernel counts its products as the tiles a warpgroup ran
    # times the wgmma its loop body issues a tile (ops.counted_products,
    # phase 8): 4 of q.k a region and 4 k-steps x the parts of P.V a
    # region; the SASS holds that body once, one HGMMA a wgmma
    listing = sass_listing(tc._name)
    for owners, regions, multi in WIDE_INSTANTIATIONS:
        found = len(re.findall(r"\bHGMMA\b", function_sass(
            listing, f"flash_attention_wgmma_wide_kernelILi{fa_ops.P_PARTS}"
                     f"ELi{owners}ELi{regions}ELb{multi}E")))
        want = 4 * regions + 4 * regions * fa_ops.P_PARTS
        print(f"wide kernel with {owners} owner(s) of {regions} regions"
              f"{' in rounds' if multi else ''}: {found} HGMMA, the "
              f"{want} wgmma it counts a tile")
        if found != want:
            raise AssertionError(f"the wide kernel ({owners}, {regions}, "
                                 f"{multi}) holds {found} HGMMA, not the "
                                 f"{want} it counts a tile")
    if not all(hgmma.values()):
        raise AssertionError(f"an instantiation of the tensor-core flash "
                             f"kernel has no HGMMA instruction: {hgmma}")

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
        sw = device_work(torch, lambda a=sl: ops.sstep_join_support(a, cand),
                         "sstep_join_kernel")
        kms = sw["kernel_ms"]
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
        slots, cand, cand_t), "frontier_join_kernel")
    full_work = device_work(torch, lambda: ops.frontier_join_support(
        full_slots, full_cand, full_cand_t), "frontier_join_kernel")
    kernel_ms = {"sparse": work["kernel_ms"], "full": full_work["kernel_ms"]}
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
    serve_requests = srv["requests"]
    serve_counts = srv["counts"]
    serve_decode_counts = srv["decode_counts"]
    del srv                         # frees the bf16 model
    torch.cuda.empty_cache()
    f32_serve = f32_greedy_check(torch, fa_ops, first_prompts)
    f32_launches = f32_serve["launches"]
    torch.cuda.empty_cache()

    # -- phase 8: flash timing at the prefill shape -----------------------
    flash = flash_timing(torch, fa_ops, fa_ref, fparity, serve_cfg, card)
    decode = decode_timing(torch, da_ops, da_ref, card)

    # phase 10's CPU run takes minutes of the host's time: it runs in a
    # process of its own beside the card's phases, read after phase 20
    cluster_cpu = in_background(cluster_cpu_start())

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
    # -- phases 12-14: the vlm, audio and moe families --------------------
    families = {}
    for spec in FAMILY_PHASES:
        families[spec.name] = family_phase(torch, fa_ops, fa_ref,
                                           count_tables, spec, card)
        phase_s[spec.name] = families[spec.name]["seconds"]
    # -- phases 15-16: the hybrid and ssm families -----------------------
    ssm_families = {}
    for spec in SSM_PHASES:
        ssm_families[spec.name] = ssm_phase(torch, fa_ops, fa_ref,
                                            count_tables, spec, card)
        phase_s[spec.name] = ssm_families[spec.name]["seconds"]
    # phases 18 (c) and 19 (d)'s dry-runs run on the host beside phases
    # 17-19
    dry = in_background(dryrun_start())
    tp_dry = in_background(tp_dryrun_start())
    # -- phase 17: training stablelm-1.6b --------------------------------
    training = train_phase(torch, fa_ops, fa_ref, count_tables, card)
    phase_s["training"] = training["seconds"]
    # -- phase 18: sharding and launch on torch.distributed ---------------
    sharding = sharding_phase(torch, fa_ops, fa_ref, count_tables, training,
                              families, card, dry)
    phase_s["sharding"] = sharding["seconds"]
    # -- phase 19: the model axis computing ---------------------------------
    tensor_parallel = tensor_parallel_phase(
        torch, fa_ops, fa_ref, count_tables, training, sharding, families,
        serve_requests, f32_serve, card, tp_dry)
    phase_s["tensor_parallel"] = tensor_parallel["seconds"]
    # -- phase 20: the model axis computing for audio, ssm and hybrid -------
    tp_families = family_tp_phase(torch, fa_ops, fa_ref, count_tables, card)
    phase_s["tensor_parallel_families"] = tp_families["seconds"]
    print("phases 9-20 seconds: " + ", ".join(
        f"{name} {sec:.1f}" for name, sec in phase_s.items()))
    t0 = time.perf_counter()
    cluster_cpu_check(cluster_cpu, cluster, card)
    print(f"phase 10's CPU run read after {time.perf_counter() - t0:.1f} s "
          f"of waiting")

    # -- phase 21: the kernels line and the result ------------------------
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
    # the tensor-core kernel is the serve paths' (codeqwen's counted here,
    # the families' and zamba2's beside it); the split-TF32 one the f32
    # checks' (phase 7's counted here, the families' beside it), each
    # timed at its path's shape
    hybrid = ssm_families["hybrid"]
    flash_paths = {"tensor_core": ("serve", serve_counts["kernel"]
                                   ["tensor_core"]),
                   "tf32x3": ("f32_check", f32_launches)}
    for which, (name, source) in FLASH_KERNELS.items():
        path, launched = flash_paths[which]
        t = flash[which]
        kernels.append({
            "name": name, "route": "cuda", "ops_route": which,
            "source": source, "replaces": FLASH_TPU_KERNEL,
            "launches": launched, "path": path,
            "parity_cases": fparity.cases[which],
            "max_abs_err": fparity.max_abs_err(which),
            "max_abs_err_f32": fparity.max_err[which, "float32"],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "tflop_s": t["tflop_s"], "bound_share": t["bound_share"],
            "shape": t["shape"], "dtype": t["dtype"], "causal": True,
            **({"rounding_share": t["rounding_share"]}
               if t["rounding_share"] is not None else {}),
            "tensor_core_instructions": tc_instructions[which],
            **{key: t[key] for key in ("ffma_bound_ms", "p_parts_ms",
                                       "p_parts_rounding_share")
               if key in t},
        })
    # each family's path (zamba2's too) launches the tensor-core kernel;
    # its f32 check the split-TF32 one
    serving = {**families, "hybrid": hybrid}
    ep = sharding["ep"]
    tp_ = tensor_parallel
    kernels[-2].update(family_launches={
        **{name: fam["launches"] for name, fam in serving.items()},
        "moe_ep": ep["launches"]}, tp_launches={
        "codeqwen": tp_["serve"]["launches"],
        "moe_ep_seq_model": tp_["ep"]["launches"],
        **{name: tp_families[name]["launches"] for name in TP_FAMILY_SPECS}},
        tp_family_prefill_s={name: tp_families[name]["prefill_s"]
                             for name in TP_FAMILY_SPECS},
        tp_prefill_s=tp_["serve"]["prefill_s"],
        tp_gate_mean_ratio=tp_["serve"]["gate"]["mean_ratio"],
        tp_moe_ep_seq_model_prefill_s=tp_["ep"]["prefill_s"],
        tp_moe_ep_seq_model_gate_mean_ratio=tp_["ep"]["gate"]["mean_ratio"],
        tp_train_step_s=tp_["train"]["step_s"], moe_ep_prefill_s=ep["prefill_s"],
        moe_ep_gate_mean_ratio=ep["gate"]["mean_ratio"], **{
        f"{name}_{key}": fam[key] for name, fam in serving.items()
        for key in ("prefill_s", "tok_s", "peak_bytes")}, **{
        f"{name}_gate_mean_ratio": fam["gate"]["mean_ratio"]
        for name, fam in serving.items()},
        hybrid_prefill_busy_share=hybrid["prefill_busy_share"],
        hybrid_prefill_flash_ms=hybrid["prefill_flash_ms"],
        hybrid_decode_busy_share=hybrid["decode_busy_share"],
        d112_tensor_core_instructions=hgmma[112],
        wide_tensor_core_instructions=hgmma["wide"],
        # training launches no flash kernel (it has no backward); the
        # trained model's prefill_step launches it once a layer
        train_launches={impl: r["launches"]
                        for impl, r in training["full"].items()},
        trained_prefill_step_launches=training["prefill"]["launches"],
        trained_gate_mean_ratio=training["prefill"]["gate"]["mean_ratio"],
        train={impl: {k: r[k] for k in (
            "step_s", "tokens_s", "flops", "mfu", "peak_bytes",
            "busy_share")} for impl, r in training["full"].items()})
    kernels[-1].update(
        f32_family_launches={
            **{name: fam["f32"]["launches"] for name, fam in serving.items()},
            "moe_ep": ep["f32"]["launches"]},
        tp_f32_launches={"codeqwen": tp_["serve"]["f32"]["launches"],
                         "moe_ep_seq_model": tp_["ep"]["f32"]["launches"],
                         **{name: tp_families[name]["f32"]["launches"]
                            for name in TP_FAMILY_SPECS}},
        f32_family_logits_max_abs_diff={
            **{name: fam["f32"]["logits_max_abs_diff"]
               for name, fam in serving.items()},
            "moe_ep_card_vs_cpu": ep["f32"]["logits_max_abs_diff"]},
        recurrent_logits_max_abs_diff={
            name: fam["recurrent"]["logits_max_abs_diff"]
            for name, fam in ssm_families.items()},
        **{f"ssm_{key}": ssm_families["ssm"][key] for key in (
            "prefill_s", "tok_s", "peak_bytes", "prefill_busy_share",
            "decode_busy_share")},
        ssm_slstm_share=ssm_families["ssm"]["slstm_share"])
    # each kernel at its other timed shapes: the tensor-core one at
    # zamba2-7b's head_dim 112 and at 256 and 512; the split-TF32 one in
    # f32 at head_dims 112, 256 and 512
    for i, key, prefix in ((-2, "tensor_core_d112", "d112"),
                           (-2, "tensor_core_d256", "d256"),
                           (-2, "tensor_core_d512", "d512"),
                           (-1, "tf32x3_d112", "d112"),
                           (-1, "tf32x3_d256", "d256"),
                           (-1, "tf32x3_d512", "d512")):
        t = flash[key]
        kernels[i].update({f"{prefix}_{k}": t[k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "bound_share", "tflop_s", "counted_qk_flop", "counted_pv_flop",
            "qk_per_tile_pair", "rounding_share",
            "shape") if t.get(k) is not None})
    # the decode-attention kernel replaces no TPU kernel; it is the serve
    # path's decode (phase 6's launches), timed at the benchmark's decode
    # batch and at phase 6's batch 4
    t = decode["decode_batch"]
    kernels.append({
        "name": "decode_attention", "route": "cuda", "source": DECODE_SOURCE,
        "replaces": None, "launches": serve_decode_counts["kernel"],
        "path": "serve", "ms": t["ms"], "device_ms": t["device_ms"],
        "plain_ms": t["plain_path_ms"], "plain_version_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": "bytes",
        "library_ms": t["library_ms"], "bound_share": t["bound_share"],
        "shape": t["shape"], "dtype": "bfloat16",
        **{f"batch4_{k}": decode["batch4"][k] for k in (
            "ms", "device_ms", "plain_path_ms", "plain_ms", "bound_ms",
            "library_ms", "bound_share", "shape", "splits")}})
    print(f"chip_smoke total: {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
