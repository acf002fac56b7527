"""PALPATINE client facade (paper §4.1 work flow, steps a..m).

``PalpatineClient`` wraps the DKV store client API unchanged (transparent to
applications): reads are intercepted by the Controller, logged by Monitoring,
served from the two-space cache when possible, and trigger background
prefetching driven by the probabilistic trees.  ``BaselineClient`` is the
unmodified client (direct store access), used as the paper's baseline.

Copied from ``src/repro/core/palpatine.py``; the port's client takes a
``device`` (default ``"cuda"``), and its mining builds the packed bitmaps
and joins them there.  Everything else runs on the host as before.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional, Sequence

from ..device import resolve_device
from .backstore import Clock, SimulatedDKVStore
from .cache import TwoSpaceCache
from .decision import build_engine
from .heuristics import HeuristicConfig
from .metastore import PatternMetastore
from .obs import (
    NULL_TRACER,
    SPAN_CACHE,
    SPAN_DECISION,
    SPAN_DEMAND,
    SPAN_OP,
    SPAN_PREFETCH,
    EVENT_SHED,
)
from .mining import (
    BITMAP_ALGOS,
    MiningParams,
    VerticalBitmaps,
    dynamic_floor_count,
    mine,
    mine_dynamic_minsup,
)
from .ptree import PTreeIndex
from .sessions import AccessLogger

__all__ = ["PalpatineConfig", "PalpatineClient", "BaselineClient"]

#: `mining_wall_time` reports *host* seconds spent in the miner — pure
#: telemetry that never feeds simulated time or mined results; the one
#: real-clock read stays behind a named alias so it is grep-able
# palplint: disable=PALP001 -- host mining telemetry, not simulation time
_telemetry_clock = time.perf_counter

#: cache bookkeeping cost per request (in-memory hash + LRU on the paper's
#: 3.4 GHz Xeon) — what a cache hit costs instead of a network round trip.
CACHE_OVERHEAD = 2e-6


@dataclasses.dataclass
class PalpatineConfig:
    heuristic: HeuristicConfig = dataclasses.field(default_factory=HeuristicConfig)
    cache_bytes: int = 32 * 1024 * 1024          # paper default working point
    preemptive_frac: float = 0.10
    mining: MiningParams = dataclasses.field(default_factory=MiningParams)
    algo: str = "vmsp"
    metastore_capacity: int = 10_000
    session_gap: float = 1.0                      # virtual seconds
    prefetch_batch: int = 16                      # per-table batching (§4.5)
    prefetch_enabled: bool = True
    # timeliness/efficiency guards (paper §1: prefetching must be timely,
    # useful, efficient): a read racing an in-flight prefetch falls back to
    # a demand fetch beyond this wait; prefetch batches are dropped when
    # the background channel is backlogged (bounded I/O amplification)
    prefetch_wait_cap: float = 2e-3
    backlog_cap: float = 0.05
    # hybrid container mining (paper §3.1 pattern type 1): additionally
    # mine COLUMN-level containers (table, column) generalized across rows;
    # predictions are instantiated with the triggering request's row
    # ("a sequence of table and columns that are accessed for a given row")
    column_mining: bool = False
    # prefetch decisions: the vectorized array engine walks all live
    # contexts in one batched program per request (flat per-op cost as
    # contexts multiply); False falls back to the scalar per-context
    # tree-walk oracle — the two are differentially identical
    use_vectorized: bool = True
    # online mining (§4.2): re-mine every N logged operations (None = offline)
    online_mine_every: Optional[int] = None
    online_tail_sessions: int = 2_000             # mine recent chunk only
    dynamic_minsup_start: float = 0.5
    dynamic_minsup_floor: float = 0.01
    min_patterns: int = 16


class PalpatineClient:
    """Drop-in DKV client with monitoring, mining, prefetching and caching."""

    def __init__(self, store: SimulatedDKVStore, config: Optional[PalpatineConfig] = None,
                 clock: Optional[Clock] = None, cache_factory=None,
                 device=None):
        #: where the miner's bitmaps live and its joins run
        self.device = resolve_device(device)
        self.store = store
        self.cfg = config or PalpatineConfig()
        self.clock = clock or Clock()
        self.logger = AccessLogger(self.cfg.session_gap)
        # cache_factory(self) may build any TwoSpaceCache-shaped object that
        # needs the client's own state — e.g. the cluster's per-shard cache
        # maps item ids back to keys through this client's vocabulary
        self.cache = (cache_factory(self) if cache_factory is not None else
                      TwoSpaceCache(self.cfg.cache_bytes, self.cfg.preemptive_frac))
        self.metastore = PatternMetastore(self.cfg.metastore_capacity,
                                          self.cfg.mining.max_len)
        self.engine = build_engine(PTreeIndex.build([]), self.cfg.heuristic,
                                   use_vectorized=self.cfg.use_vectorized)
        self.col_logger = AccessLogger(self.cfg.session_gap)
        # column patterns are instantiated with the *current* request's row,
        # so they are always walked progressively (one confirmed step ->
        # next level), regardless of the main heuristic
        self.col_engine = build_engine(
            PTreeIndex.build([]),
            HeuristicConfig("fetch_progressive", progressive_depth=2),
            use_vectorized=self.cfg.use_vectorized)
        self.col_metastore: Optional[PatternMetastore] = None
        self._ops_since_mine = 0
        self.mining_runs = 0
        self.mining_wall_time = 0.0
        # packed-bitmap reuse across mining runs: {"main"/"col": (fp, vb)}
        self._vb_cache: dict = {}
        self._last_mine_events: Optional[int] = None
        self._last_mine_generation: Optional[int] = None
        #: demand reads that paid >= 1 replica ack timeout before landing
        #: (the client-visible cost of not-yet-suspected crashed replicas:
        #: non-zero only during the failure detector's discovery window)
        self.demand_timeouts = 0
        store.watch(self._on_store_write)
        self._in_write = False
        # Palpascope: share the store's tracer (NULL_TRACER unless
        # enable_tracing was called on the store/cluster), and have both
        # engines name the pattern behind every emitted prefetch target
        self.tracer = getattr(store, "tracer", NULL_TRACER)
        self.engine.attribute = True
        self.col_engine.attribute = True

    # ------------------------------------------------------------------
    # Client API (mirrors the store's get/put — transparent, §4.5)
    # ------------------------------------------------------------------
    def _demand_fetch(self, key, now: float):
        """One demand read as a future: (value, completion_time).  Stores
        without the futures API fall back to the blocking get."""
        get_async = getattr(self.store, "get_async", None)
        if get_async is None:
            value, lat = self.store.get(key)
            return value, now + lat
        fut = get_async(key, now)
        if getattr(fut, "timed_out", False):
            self.demand_timeouts += 1
        return fut.value(), fut.done_at

    def read(self, container) -> tuple[Any, float]:
        """Returns (value, virtual latency).  Advances the virtual clock."""
        now = self.clock.now
        tr = self.tracer
        sp = tr.start(SPAN_OP, now)
        try:
            self.logger.record(now, container)
            iid = self.logger.db.item_id(container)
            if sp.live:
                sp.set(op="read", key=self._store_key(container))
            if self.cfg.column_mining:
                self.col_logger.record(now, self._generalize(container))

            csp = tr.span(SPAN_CACHE, now)
            hit = self.cache.lookup(iid, now)
            if csp.live:
                csp.set(hit=hit is not None)
            tr.end(csp, now)
            if hit is not None and hit[1] <= self.cfg.prefetch_wait_cap:
                value, wait = hit
                latency = CACHE_OVERHEAD + wait
            else:
                # miss, or the prefetch is too far in flight: demand-fetch
                # wins the race (timeliness failure, counted against
                # precision by the still-pending preemptive entry)
                dsp = tr.span(SPAN_DEMAND, now)
                try:
                    value, done_at = self._demand_fetch(
                        self._store_key(container), now)
                    dsp.finish(done_at)
                finally:
                    tr.end(dsp)
                latency = (done_at - now) + CACHE_OVERHEAD
                if value is not None:
                    self.cache.put_demand(iid, value, len(value))

            if self.cfg.prefetch_enabled:
                self._prefetch(iid, now)
                if self.cfg.column_mining:
                    self._prefetch_columns(container, now)
            self._maybe_online_mine()
            self.clock.advance(latency)
            sp.finish(now + latency)
            return value, latency
        except BaseException:
            sp.mark("error")
            raise
        finally:
            tr.end(sp)

    def read_many(self, containers: Sequence) -> tuple[list, float]:
        """Batched read with overlapping in-flight demand fetches.

        All containers are logged in order (one monitoring event each, so
        mining sees the same sequence a loop of ``read`` would produce);
        cache hits are served locally and every miss joins one scatter-
        gather ``multi_get_async`` whose sub-batches pipeline concurrently
        across shards — the batch completes when the slowest node (or the
        longest still-in-flight prefetch) lands, not at the sum of
        per-key round trips.  Returns (values, batch latency)."""
        now = self.clock.now
        tr = self.tracer
        sp = tr.start(SPAN_OP, now)
        try:
            if sp.live:
                sp.set(op="read_many", n=len(containers))
            self.logger.record_many(now, containers)
            if self.cfg.column_mining:
                self.col_logger.record_many(
                    now, [self._generalize(c) for c in containers])
            values: list = [None] * len(containers)
            iids: list[int] = []
            misses: list[tuple[int, int, Any]] = []   # (position, iid, key)
            worst_wait = 0.0
            csp = tr.span(SPAN_CACHE, now)
            for pos, container in enumerate(containers):
                iid = self.logger.db.item_id(container)
                iids.append(iid)
                hit = self.cache.lookup(iid, now)
                if hit is not None and hit[1] <= self.cfg.prefetch_wait_cap:
                    values[pos] = hit[0]
                    worst_wait = max(worst_wait, hit[1])
                else:
                    misses.append((pos, iid, self._store_key(container)))
            if csp.live:
                csp.set(hits=len(containers) - len(misses),
                        misses=len(misses))
            tr.end(csp, now)

            done_at = now + worst_wait
            if misses:
                keys = [k for _, _, k in misses]
                dsp = tr.span(SPAN_DEMAND, now)
                try:
                    multi_async = getattr(self.store, "multi_get_async", None)
                    if multi_async is None:
                        vals, lat = self.store.multi_get(keys)
                        batch_done = now + lat
                    else:
                        fut = multi_async(keys, now)
                        vals, batch_done = fut.result()
                        if getattr(fut, "timed_out", False):
                            self.demand_timeouts += 1
                    dsp.finish(batch_done)
                finally:
                    tr.end(dsp)
                for (pos, iid, _), v in zip(misses, vals):
                    values[pos] = v
                    if v is not None:
                        self.cache.put_demand(iid, v, len(v))
                done_at = max(done_at, batch_done)

            latency = (done_at - now) + CACHE_OVERHEAD * len(containers)
            if self.cfg.prefetch_enabled:
                for iid, container in zip(iids, containers):
                    self._prefetch(iid, now)
                    if self.cfg.column_mining:
                        self._prefetch_columns(container, now)
            self._maybe_online_mine()
            self.clock.advance(latency)
            sp.finish(now + latency)
            return values, latency
        except BaseException:
            sp.mark("error")
            raise
        finally:
            tr.end(sp)

    def write(self, container, value: bytes) -> float:
        """Write-through cache update + async store write (§4.4); returns
        the (small) foreground latency."""
        now = self.clock.now
        tr = self.tracer
        sp = tr.start(SPAN_OP, now)
        iid = self.logger.db.item_id(container)
        if sp.live:
            sp.set(op="write", key=self._store_key(container))
        self._in_write = True
        try:
            self.store.put(self._store_key(container), value, now)
            sp.finish(now + CACHE_OVERHEAD)
        except BaseException:
            sp.mark("error")
            raise
        finally:
            self._in_write = False
            tr.end(sp)
        self.cache.write(iid, value, len(value))
        self.clock.advance(CACHE_OVERHEAD)
        return CACHE_OVERHEAD

    def end_session(self) -> None:
        """Explicit session cut (end of a transaction/request)."""
        self.logger.flush_session()
        self.col_logger.flush_session()

    # ------------------------------------------------------------------
    # Mining control (stage 1 -> stage 2 in the benchmarks)
    # ------------------------------------------------------------------
    def _cached_bitmaps(self, logger: AccessLogger, db, count: int,
                        which: str) -> Optional[VerticalBitmaps]:
        """The previous run's packed bitmaps, iff the logged tail is
        unchanged (same event count, session count, vocabulary and support
        count) — an online re-mine over an idle backlog then skips the
        scatter/pack entirely.  Returns None on miss (no build here: the
        dynamic-minsup path only pays the floor build if a decay retry
        actually happens)."""
        if self.cfg.algo not in BITMAP_ALGOS:
            return None
        fp = (logger.n_events, len(db.sessions), db.n_items, count)
        hit = self._vb_cache.get(which)
        return hit[1] if hit is not None and hit[0] == fp else None

    def _build_bitmaps(self, logger: AccessLogger, db, count: int,
                       which: str) -> Optional[VerticalBitmaps]:
        """Build + cache packed bitmaps for ``db`` at support ``count``."""
        if self.cfg.algo not in BITMAP_ALGOS:
            return None
        vb = VerticalBitmaps(db, count, self.device)
        fp = (logger.n_events, len(db.sessions), db.n_items, count)
        self._vb_cache[which] = (fp, vb)
        return vb

    def _floor_count(self, db, floor: float) -> int:
        return dynamic_floor_count(
            self.cfg.mining, len(db), self.cfg.dynamic_minsup_start, floor)

    def mine_now(self, use_dynamic_minsup: bool = True) -> int:
        """Run the Data Mining Engine on the backlog, furnish the metastore,
        rebuild the probabilistic trees.  Returns #patterns stored."""
        if self.cfg.column_mining:
            self._mine_columns(use_dynamic_minsup)
        db = self.logger.snapshot()
        if self.cfg.online_mine_every is not None:
            db = db.tail(self.cfg.online_tail_sessions)
        t0 = _telemetry_clock()
        if use_dynamic_minsup:
            floor_count = self._floor_count(db, self.cfg.dynamic_minsup_floor)
            vb = self._cached_bitmaps(self.logger, db, floor_count, "main")
            patterns, _ = mine_dynamic_minsup(
                db, self.cfg.mining, self.cfg.algo,
                start=self.cfg.dynamic_minsup_start,
                floor=self.cfg.dynamic_minsup_floor,
                min_patterns=self.cfg.min_patterns,
                vb=vb,
                vb_factory=lambda: self._build_bitmaps(
                    self.logger, db, floor_count, "main"),
                device=self.device,
            )
        else:
            count = self.cfg.mining.minsup_count(len(db))
            vb = self._cached_bitmaps(self.logger, db, count, "main")
            if vb is None:
                vb = self._build_bitmaps(self.logger, db, count, "main")
            patterns = mine(db, self.cfg.mining, self.cfg.algo, vb=vb,
                            device=self.device)
        self.mining_wall_time += _telemetry_clock() - t0
        self.mining_runs += 1
        self._last_mine_events = self.logger.n_events
        # a sequence observed once is not a pattern: support >= 2 sessions
        patterns = [p for p in patterns if p.support >= 2]
        self.metastore.populate(patterns)
        self.engine.replace_index(PTreeIndex.build(self.metastore))
        self._last_mine_generation = self.metastore.generation
        return len(self.metastore)

    def backlog_unchanged_since_mine(self) -> bool:
        """True when no read has been logged since the last ``mine_now``
        AND nothing touched the metastore since (gossip merges / apriori
        adds bump its generation) — only then would a re-mine leave the
        metastore byte-identical (mine_now *replaces* contents, so merged
        foreign patterns must force the full run)."""
        return (self._last_mine_events is not None
                and self._last_mine_events == self.logger.n_events
                and self._last_mine_generation == self.metastore.generation)

    def _maybe_online_mine(self) -> None:
        if self.cfg.online_mine_every is None:
            return
        self._ops_since_mine += 1
        if self._ops_since_mine >= self.cfg.online_mine_every:
            self._ops_since_mine = 0
            self.mine_now()

    # ------------------------------------------------------------------
    # Hybrid column-level mining (paper §3.1 type 1)
    # ------------------------------------------------------------------
    @staticmethod
    def _generalize(container):
        key = container.key() if hasattr(container, "key") else container
        if isinstance(key, tuple) and len(key) == 3:
            return (key[0], None, key[2])     # (table, *, column)
        return key

    def _mine_columns(self, use_dynamic_minsup: bool = True) -> None:
        db = self.col_logger.snapshot()
        if self.cfg.online_mine_every is not None:
            db = db.tail(self.cfg.online_tail_sessions)
        floor = max(self.cfg.dynamic_minsup_floor, 2.0 / max(len(db), 1))
        if use_dynamic_minsup:
            floor_count = self._floor_count(db, floor)
            vb = self._cached_bitmaps(self.col_logger, db, floor_count, "col")
            patterns, _ = mine_dynamic_minsup(
                db, self.cfg.mining, self.cfg.algo,
                start=self.cfg.dynamic_minsup_start,
                floor=floor,
                min_patterns=self.cfg.min_patterns,
                vb=vb,
                vb_factory=lambda: self._build_bitmaps(
                    self.col_logger, db, floor_count, "col"),
                device=self.device)
        else:
            count = self.cfg.mining.minsup_count(len(db))
            vb = self._cached_bitmaps(self.col_logger, db, count, "col")
            if vb is None:
                vb = self._build_bitmaps(self.col_logger, db, count, "col")
            patterns = mine(db, self.cfg.mining, self.cfg.algo, vb=vb,
                            device=self.device)
        patterns = [p for p in patterns if p.support >= 2]
        ms = PatternMetastore(self.cfg.metastore_capacity,
                              self.cfg.mining.max_len)
        ms.populate(patterns)
        self.col_metastore = ms
        self.col_engine.replace_index(PTreeIndex.build(ms))

    def _prefetch_columns(self, container, now: float) -> None:
        """Instantiate predicted (table, column) containers with the
        triggering request's row and prefetch the concrete cells."""
        key = container.key() if hasattr(container, "key") else container
        if not (isinstance(key, tuple) and len(key) == 3):
            return
        row = key[1]
        gen_iid = self.col_logger.db.item_id(self._generalize(container))
        targets = self.col_engine.on_request(gen_iid)
        if not targets:
            return
        if self.store.backlog(now) > self.cfg.backlog_cap:
            return
        causes = self.col_engine.last_attribution() or [None] * len(targets)
        memo: dict = {}
        concrete = []
        for t, c in zip(targets, causes):
            table, _, col = self.col_logger.db.item(t)
            ckey = (table, row, col)
            if not self.store.contains(ckey):
                continue
            iid = self.logger.db.item_id(ckey)
            if not self.cache.contains(iid):
                concrete.append(
                    (iid, ckey, self._resolve_cause(c, memo, column=True)))
        for i in range(0, len(concrete), self.cfg.prefetch_batch):
            batch = concrete[i:i + self.cfg.prefetch_batch]
            keys = [k for _, k, _ in batch]
            vals, done_ats = self.store.background_multi_get(
                keys, now, self.cfg.backlog_cap)
            for (iid, _, cause), v, done_at in zip(batch, vals, done_ats):
                if v is not None:
                    self.cache.put_prefetch(iid, v, len(v), done_at,
                                            cause=cause)

    # ------------------------------------------------------------------
    # Prefetching (background, §4.1 step j / §4.5 batching)
    # ------------------------------------------------------------------
    def _resolve_cause(self, cause, memo: dict, column: bool = False):
        """Rewrite a cause's tree-root *item id* (client-local vocab) into
        the root *container key*, so attribution rows aggregate across
        tenants/shards that number items differently."""
        if cause is None:
            return None
        key = memo.get(cause.root)
        if key is None:
            db = self.col_logger.db if column else self.logger.db
            key = memo[cause.root] = db.item(cause.root)
        return dataclasses.replace(cause, root=key)

    def _prefetch(self, iid: int, now: float) -> None:
        tr = self.tracer
        if self.store.backlog(now) > self.cfg.backlog_cap:
            tr.event(EVENT_SHED, now)
            return  # background channel(s) saturated: shed prefetch load
        dsp = tr.span(SPAN_DECISION, now)
        targets = self.engine.on_request(iid)
        causes = (self.engine.last_attribution() or [None] * len(targets)) \
            if targets else []
        if dsp.live:
            dsp.set(targets=len(targets))
        tr.end(dsp, now)
        memo: dict = {}
        wanted = [(i, self._resolve_cause(c, memo))
                  for i, c in zip(targets, causes)
                  if not self.cache.contains(i)]
        if not wanted:
            return
        # First wave item goes unbatched (anticipate the next request,
        # §4.5); the rest batched per prefetch_batch.  A sharded store
        # splits each batch per owning node and sheds per-node past the
        # backlog cap; completion times are per key.
        batches = [wanted[:1]]
        rest = wanted[1:]
        for i in range(0, len(rest), self.cfg.prefetch_batch):
            batches.append(rest[i:i + self.cfg.prefetch_batch])
        psp = tr.span(SPAN_PREFETCH, now)
        try:
            admitted, last_done = 0, now
            for batch in batches:
                if not batch:
                    continue
                keys = [self._store_key_by_id(i) for i, _ in batch]
                vals, done_ats = self.store.background_multi_get(
                    keys, now, self.cfg.backlog_cap)
                for (i, cause), v, done_at in zip(batch, vals, done_ats):
                    if v is not None:
                        self.cache.put_prefetch(i, v, len(v), done_at,
                                                cause=cause)
                        admitted += 1
                        if done_at > last_done:
                            last_done = done_at
            if psp.live:
                psp.set(n_targets=len(wanted), n_admitted=admitted,
                        done_at=last_done)
        finally:
            # background work: the span closes at issue time (children
            # nest within the op) — batch completion is the done_at field
            tr.end(psp, now)

    # ------------------------------------------------------------------
    def _store_key(self, container):
        return container.key() if hasattr(container, "key") else container

    def _store_key_by_id(self, iid: int):
        return self.logger.db.item(iid)

    def on_keys_remapped(self, keys: Sequence) -> None:
        """Cluster membership change: these container keys moved to a new
        primary node.  A per-shard cache must drop their (now misfiled)
        entries and partition placement — a *targeted* invalidation, not a
        full flush.  Plain caches keep everything: the values themselves
        did not change, only their placement."""
        rehome = getattr(self.cache, "rehome", None)
        if rehome is None:
            return
        vocab = self.logger.db._vocab
        rehome([iid for k in keys
                if (iid := vocab.get(k)) is not None])

    def _on_store_write(self, key) -> None:
        """Coherence: the store-side monitor notifies on writes.  Our own
        writes update the cache in place; external writers invalidate."""
        if self._in_write:
            return
        vocab = self.logger.db._vocab
        iid = vocab.get(key)
        if iid is not None:
            self.cache.invalidate(iid)

    @property
    def stats(self):
        return self.cache.stats


class BaselineClient:
    """The unmodified DKV client: every read is a store round trip (issued
    through the same futures RPC layer, so baseline and Palpatine see
    identical channel contention)."""

    def __init__(self, store: SimulatedDKVStore, clock: Optional[Clock] = None):
        self.store = store
        self.clock = clock or Clock()

    def read(self, container) -> tuple[Any, float]:
        key = container.key() if hasattr(container, "key") else container
        now = self.clock.now
        get_async = getattr(self.store, "get_async", None)
        if get_async is None:
            value, latency = self.store.get(key)
        else:
            fut = get_async(key, now)
            value, latency = fut.value(), fut.done_at - now
        self.clock.advance(latency)
        return value, latency

    def read_many(self, containers: Sequence) -> tuple[list, float]:
        """Scatter-gather demand read: sub-batches overlap across shards,
        the batch completes when the slowest node lands."""
        keys = [c.key() if hasattr(c, "key") else c for c in containers]
        now = self.clock.now
        multi_async = getattr(self.store, "multi_get_async", None)
        if multi_async is None:
            values, latency = self.store.multi_get(keys)
        else:
            fut = multi_async(keys, now)
            values, done_at = fut.result()
            latency = done_at - now
        self.clock.advance(latency)
        return values, latency

    def write(self, container, value: bytes) -> float:
        key = container.key() if hasattr(container, "key") else container
        self.store.put(key, value, self.clock.now)
        self.clock.advance(CACHE_OVERHEAD)
        return CACHE_OVERHEAD
