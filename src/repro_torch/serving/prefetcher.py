"""PALPATINE-powered predictive expert prefetching, served by the cluster.

Copied from ``src/repro/serving/prefetcher.py``; ``ExpertStore`` and
``ExpertPrefetcher`` take a ``device`` (default the card): decoded and
fetched weights are torch tensors there, and the prefetcher's
``PalpatineClient``, the port's, mines there.

This is the paper's technique integrated as a first-class framework
feature (DESIGN.md §2), now wired through the sharded cluster instead of
a private in-process cache: MoE expert weights live in ``ShardedDKVStore``
shards keyed by ``(layer, expert)`` containers, the per-request
expert-routing path is the session stream VMSP mines, and every fetch —
demand or background — rides the cluster's chaos/tracing RPC chokepoints
on the virtual clock.

  ExpertStore      — the back store *view*: host ground-truth weights
                     mirrored into cluster shards as raw bytes; decodes
                     stored values back to device tensors.
  ExpertPrefetcher — a :class:`repro_torch.core.api.Client` composed over a
                     ``PalpatineClient`` with the cluster's per-shard
                     ``ShardedTwoSpaceCache`` and (optionally) the
                     gossiped ``PatternExchange`` metastore.

The access pattern of MoE routing is exactly the paper's regime: strongly
recurrent frequent sequences (expert affinity across layers is sticky for
a given prompt domain) over a large key space (L × E containers).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core import (
    HeuristicConfig,
    MiningParams,
    PalpatineClient,
    PalpatineConfig,
    PatternExchange,
    ShardedDKVStore,
    ShardedTwoSpaceCache,
)
from ..core.obs import (
    METRIC_DEMAND_WAIT,
    METRIC_OPS,
    METRIC_READ_LATENCY,
    METRIC_SESSIONS,
    METRIC_STORE_FETCHES,
    MetricsRegistry,
)
from ..device import resolve_device

__all__ = ["ExpertStore", "ExpertPrefetcher", "PrefetcherConfig"]


class ExpertStore:
    """Expert weights keyed by (layer, expert), resident in cluster shards.

    The host ``weights`` dict is the ground truth (tests compare against
    it); the same arrays are loaded into the ``ShardedDKVStore`` as raw
    bytes so reads, replication, membership changes, chaos schedules and
    tracing all apply to expert traffic exactly as to any other
    container.  ``decode`` turns a stored value back into a torch tensor
    on ``device`` (default the card), where the reference puts a jax
    array on its device.
    """

    def __init__(self, n_layers: int, n_experts: int, d: int, f: int,
                 dtype=np.float32, seed: int = 0,
                 dkv: Optional[ShardedDKVStore] = None, n_shards: int = 2,
                 device=None):
        self.device = resolve_device(device)
        rng = np.random.default_rng(seed)
        self.dtype = np.dtype(dtype)
        self.shape = (d, f)
        self.weights = {
            (l, e): rng.standard_normal((d, f)).astype(self.dtype)
            for l in range(n_layers) for e in range(n_experts)
        }
        self.n_layers, self.n_experts = n_layers, n_experts
        self.item_bytes = d * f * self.dtype.itemsize
        self.dkv = dkv if dkv is not None else ShardedDKVStore(n_shards)
        self.dkv.load((k, w.tobytes()) for k, w in self.weights.items())
        self.fetches = 0

    def nbytes(self, key) -> int:
        return self.weights[key].nbytes

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        # a copy: stored bytes are read-only, and the weights stay the
        # host's ground truth
        return torch.from_numpy(np.array(arr)).to(self.device)

    def decode(self, value):
        """Stored bytes -> device tensor; non-expert payloads (foreign
        writes, KV shards) pass through untouched."""
        if (not isinstance(value, (bytes, bytearray, memoryview))
                or len(value) != self.item_bytes):
            return value
        return self._to_device(
            np.frombuffer(value, self.dtype).reshape(self.shape))

    def fetch(self, key):
        """Deprecated: direct host->device transfer that bypasses the
        cluster.  Kept for callers that pre-stage weights outside the
        monitored path; use ``ExpertPrefetcher.read`` instead."""
        self.fetches += 1
        return self._to_device(self.weights[key])


@dataclasses.dataclass
class PrefetcherConfig:
    heuristic: HeuristicConfig = dataclasses.field(
        default_factory=lambda: HeuristicConfig("fetch_progressive"))
    cache_experts: int = 16            # device-resident expert slots
    preemptive_frac: float = 0.25
    mining: MiningParams = dataclasses.field(
        default_factory=lambda: MiningParams(minsup=0.05, min_len=3,
                                             max_len=15, maxgap=1))
    mine_every_sessions: int = 64
    # a read racing an in-flight prefetch demand-fetches past this wait
    prefetch_wait_cap: float = 2e-3
    # batched decision engine (flat per-op cost across live contexts);
    # False = scalar per-context oracle, differentially identical
    use_vectorized: bool = True
    min_patterns: int = 8


class ExpertPrefetcher:
    """The PALPATINE pipeline over a cluster-resident ``ExpertStore``.

    A :class:`repro_torch.core.api.Client`: composes a ``PalpatineClient``
    against ``store.dkv`` with the cluster's per-shard two-space cache,
    so monitoring, mining, probabilistic trees, heuristics, prefetch
    batching/shedding, tracing and chaos adjudication are all the
    cluster's own — nothing here re-implements them.  Metrics are
    ``MetricsRegistry``-backed; the dict-shaped ``stats`` view is
    retained for existing benchmarks/examples.  Its client mines on
    ``device`` (default the card).
    """

    def __init__(self, store: ExpertStore,
                 cfg: Optional[PrefetcherConfig] = None,
                 exchange: Optional[PatternExchange] = None,
                 clock=None, device=None):
        self.store = store
        self.cfg = cfg or PrefetcherConfig()
        pcfg = PalpatineConfig(
            heuristic=self.cfg.heuristic,
            cache_bytes=self.cfg.cache_experts * store.item_bytes,
            preemptive_frac=self.cfg.preemptive_frac,
            mining=self.cfg.mining,
            session_gap=float("inf"),          # explicit end_session cuts
            prefetch_wait_cap=self.cfg.prefetch_wait_cap,
            use_vectorized=self.cfg.use_vectorized,
            min_patterns=self.cfg.min_patterns,
        )
        dkv = store.dkv

        def factory(client: PalpatineClient) -> ShardedTwoSpaceCache:
            return ShardedTwoSpaceCache(
                dkv.n_shards, pcfg.cache_bytes, pcfg.preemptive_frac,
                key_of=client.logger.db.item, shard_of=dkv.shard_of)

        self.client = PalpatineClient(dkv, pcfg, clock=clock,
                                      cache_factory=factory, device=device)
        #: gossiped cluster metastore; mine_now publishes + pulls when set
        self.exchange = exchange
        self.metrics = MetricsRegistry()
        self._ops = self.metrics.counter(METRIC_OPS)
        self._sessions = self.metrics.counter(METRIC_SESSIONS)
        self._demand_wait = self.metrics.gauge(METRIC_DEMAND_WAIT)
        self._store_fetches = self.metrics.gauge(METRIC_STORE_FETCHES)
        self._read_latency = self.metrics.histogram(METRIC_READ_LATENCY)
        self._sessions_since_mine = 0

    # -- delegated pipeline state (one source of truth: the client) -------
    @property
    def cache(self):
        return self.client.cache

    @property
    def logger(self):
        return self.client.logger

    @property
    def metastore(self):
        return self.client.metastore

    @property
    def engine(self):
        return self.client.engine

    @property
    def clock(self):
        return self.client.clock

    @property
    def demand_wait_s(self) -> float:
        """Virtual seconds demand reads spent waiting on the cluster."""
        return self._demand_wait.value

    # -- Client surface ----------------------------------------------------
    def read(self, container):
        """One monitored expert/KV read: (decoded value, virtual latency)."""
        misses0 = self.cache.stats.misses
        value, latency = self.client.read(container)
        self._ops.inc()
        self._read_latency.record(latency)
        if self.cache.stats.misses > misses0:
            self._demand_wait.set(self._demand_wait.value + latency)
        return self.store.decode(value), latency

    def read_many(self, containers):
        """Batched read (overlapped in-flight fetches): (values, latency)."""
        misses0 = self.cache.stats.misses
        values, latency = self.client.read_many(containers)
        self._ops.inc(len(containers))
        self._read_latency.record(latency)
        if self.cache.stats.misses > misses0:
            self._demand_wait.set(self._demand_wait.value + latency)
        return [self.store.decode(v) for v in values], latency

    def write(self, container, value) -> float:
        """Write-through expert update; arrays are serialized and the
        host ground-truth mirror is kept in sync."""
        if isinstance(value, np.ndarray):
            self.store.weights[container] = value.astype(self.store.dtype)
            value = self.store.weights[container].tobytes()
        return self.client.write(container, value)

    def end_session(self) -> None:
        """A request finished: cut the session; maybe re-mine."""
        self.client.end_session()
        self._sessions.inc()
        self._sessions_since_mine += 1
        if self._sessions_since_mine >= self.cfg.mine_every_sessions:
            self._sessions_since_mine = 0
            self.mine_now()

    def mine_now(self, use_dynamic_minsup: bool = True) -> int:
        """Mine the routing backlog; gossip through the cluster exchange
        when one is attached (publish ours, pull the cluster's)."""
        self.client.mine_now(use_dynamic_minsup)
        if self.exchange is not None:
            self.exchange.publish(self.client)
            self.exchange.pull(self.client)
        return len(self.client.metastore)

    # -- deprecated shims --------------------------------------------------
    def access(self, layer: int, expert: int):
        """Deprecated: ``read((layer, expert))`` is the unified surface.
        Returns only the decoded weight (old calling convention)."""
        value, _ = self.read((layer, expert))
        return value

    # -- cluster wiring ----------------------------------------------------
    def enable_tracing(self, tracer) -> None:
        """Palpascope spans from the client's cache lookup down to the
        replica's service interval — the cluster wiring shape."""
        self.store.dkv.enable_tracing(tracer)
        self.client.tracer = tracer

    def enable_chaos(self, engine) -> None:
        """Fault schedules adjudicate every expert fetch RPC."""
        self.store.dkv.enable_chaos(engine)

    # -- observability -----------------------------------------------------
    @property
    def stats(self):
        """Dict-shaped view over the MetricsRegistry snapshot + cache
        counters (``tools/palpascope.py`` renders the ``attr_*`` keys
        like a cluster run's)."""
        s = self.cache.stats
        attr = self.cache.attr
        self._store_fetches.set(self.store.dkv.gets)
        snap = self.metrics.snapshot()
        return {
            "hit_rate": s.hit_rate,
            "precision": s.precision,
            "prefetches": s.prefetches,
            "prefetch_hits": s.prefetch_hits,
            "demand_wait_s": snap[METRIC_DEMAND_WAIT],
            "store_fetches": snap[METRIC_STORE_FETCHES],
            "ops": snap[METRIC_OPS],
            "sessions": snap[METRIC_SESSIONS],
            "read_latency": snap[METRIC_READ_LATENCY],
            "attr_waste_ratio": attr.waste_ratio,
            "attr_top_patterns": attr.top_rows(5),
        }
