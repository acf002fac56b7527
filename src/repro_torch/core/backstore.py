"""Simulated DKV back store (HBase stand-in) with a calibrated latency model.

Copied unchanged from ``src/repro/core/backstore.py``: the port keeps
its own copy and imports nothing from ``repro``.

This container has no HBase; the back store is a real in-process KV map with
a *virtual-clock* latency model calibrated to the paper's setting (two
machines on a 100 Mbps LAN, HDD-backed region server):

  demand get (foreground):  rtt + items·service + bytes/bandwidth
  batched prefetch (background): one rtt per batch + per-item service
  write: acknowledged asynchronously (paper §4.4), accounted on the
         background channel.

Prefetches run on a dedicated background channel (the paper's low-priority
thread): they never serialize with demand fetches, but an item is only
*available* in cache once its batch completes — a demand read arriving
earlier blocks for the remainder (timeliness, §1).

Demand reads are *futures-based*: ``get_async`` / ``multi_get_async`` issue
the RPC on the node's demand channel (a fixed-width request pipeline, like
a region server's RPC handler pool) and return an :class:`RPCFuture`
carrying the issue time and the virtual completion time, so a client can
keep several reads in flight across nodes and account completion with
``max`` instead of ``sum`` — the read-path overlap that hides per-node
tail latency.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Optional, Sequence

import numpy as np

from .obs import NULL_TRACER, SPAN_RPC, SPAN_SERVICE

__all__ = ["Clock", "LatencyModel", "Channel", "RPCFuture",
           "SimulatedDKVStore"]


class Clock:
    """Virtual time in seconds."""

    def __init__(self) -> None:
        self.now = 0.0

    def advance(self, dt: float) -> float:
        self.now += dt
        return self.now

    def sync(self, t: float) -> float:
        """Jump forward to at least ``t`` (never backwards).  A client
        joining a running cluster must sync to the store's
        :meth:`~SimulatedDKVStore.frontier` first: store channels are
        shared, and reads issued from a lagging clock would be charged
        for queueing behind their own future."""
        self.now = max(self.now, float(t))
        return self.now


class Channel:
    """Fixed-width FIFO request pipeline on the virtual clock.

    ``width`` RPCs can be in service at once (a region server's handler
    pool); further requests queue behind the earliest-free lane.  Width 1
    recovers the strictly serial channel used for prefetch batches and the
    write-behind WAL path.

    Channels are shared store-side state: clients issuing against the same
    node must keep their virtual clocks roughly synchronized (the cluster
    drivers interleave tenants most-behind-first for exactly this reason).
    A client reading at a ``now`` far behind the channel frontier would be
    charged for queueing behind requests from its own future.
    """

    def __init__(self, width: int = 1):
        self.lanes = [0.0] * max(1, int(width))
        self.issued = 0          # RPCs admitted (ack accounting)

    @property
    def free_at(self) -> float:
        """When the earliest lane frees up (single-lane: the channel)."""
        return min(self.lanes)

    @free_at.setter
    def free_at(self, t: float) -> None:
        self.lanes = [float(t)] * len(self.lanes)

    def backlog(self, now: float) -> float:
        """Wait before a new request would enter service."""
        return max(0.0, self.free_at - now)

    def issue(self, now: float, service: float) -> float:
        """Enqueue one RPC at virtual time ``now``; returns completion."""
        i = min(range(len(self.lanes)), key=self.lanes.__getitem__)
        done = max(now, self.lanes[i]) + service
        self.lanes[i] = done
        self.issued += 1
        return done


@dataclasses.dataclass
class RPCFuture:
    """A demand read in flight: resolved values plus completion times on
    the virtual clock.  The store resolves values eagerly (the simulation
    knows them); *time* is what stays outstanding."""

    keys: tuple
    values: list
    issue_time: float
    done_at: float                       # when the whole RPC lands
    done_each: list = dataclasses.field(default_factory=list)  # per key
    node: Optional[int] = None           # serving node (sharded stores)
    #: missed-ack accounting for the failure detector: True when the RPC
    #: (or one of its attempts) expired instead of acking, and how many
    #: replica retries the coordinator paid before this future resolved
    timed_out: bool = False
    retries: int = 0
    #: the chaos engine dropped this message before it reached the node —
    #: the sender sees exactly a timeout (no ack), but the node never
    #: served it (no counters moved), so the coordinator must retry
    dropped: bool = False

    def result(self) -> tuple[list, float]:
        return self.values, self.done_at

    def value(self):
        """Single-key convenience."""
        return self.values[0]

    def wait(self, now: float) -> float:
        """Remaining in-flight time as seen from ``now``."""
        return max(0.0, self.done_at - now)


@dataclasses.dataclass
class LatencyModel:
    """Calibrated to the paper's testbed (§5 'Setting'): 100 Mbps network,
    7200 RPM HDD behind HBase's read path.  Service time carries lognormal
    jitter plus occasional long-tail stalls (compactions / GC pauses), so
    latency percentiles behave like a real store's."""

    rtt: float = 500e-6            # network round trip
    per_item_service: float = 150e-6  # store-side lookup/seek amortized
    bandwidth: float = 12.5e6      # bytes/s (100 Mbps)
    jitter_sigma: float = 0.25     # lognormal sigma on the service term
    stall_frac: float = 0.01       # long-tail stall probability
    stall_mult: float = 8.0
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def _jitter(self) -> float:
        j = float(np.exp(self._rng.normal(0.0, self.jitter_sigma)))
        if self._rng.random() < self.stall_frac:
            j *= self.stall_mult
        return j

    def get(self, n_items: int, total_bytes: int) -> float:
        base = (self.rtt + n_items * self.per_item_service
                + total_bytes / self.bandwidth)
        return base * self._jitter()

    def put(self, n_items: int, total_bytes: int) -> float:
        base = (self.rtt + n_items * self.per_item_service
                + total_bytes / self.bandwidth)
        return base * self._jitter()


class SimulatedDKVStore:
    """Wide-columnar KV store: keys are container keys, values are bytes."""

    #: demand RPC handler pool per node — concurrent clients' in-flight
    #: reads pipeline through these lanes instead of magically overlapping
    DEMAND_WIDTH = 4

    def __init__(self, latency: Optional[LatencyModel] = None,
                 demand_width: int = DEMAND_WIDTH):
        self.latency = latency or LatencyModel()
        self.data: dict[Any, bytes] = {}
        #: per-key write version, stamped by a replicating front-end
        #: (ShardedDKVStore's put frontier).  Replicas whose version for a
        #: key trails the newest are *stale* — the signal read-repair and
        #: hinted-handoff draining converge on.  The node itself is
        #: version-agnostic: values are ints (legacy monotone counters) or
        #: ``repro.core.versions.DottedVersion`` objects, both totally
        #: ordered, with absent == version 0.  A standalone node never
        #: populates it.
        self.versions: dict[Any, Any] = {}
        self.demand = Channel(demand_width)     # foreground RPC pipeline
        self.background = Channel(1)   # prefetch channel
        self.write_channel = Channel(1)  # write-behind channel (WAL path)
        self.gets = 0
        self.bytes_served = 0
        #: crashed == the process is gone: RPCs to this node never ack (the
        #: sharded front-end observes timeouts and feeds the failure
        #: detector).  Unlike ``ShardedDKVStore.set_down`` — a *declared*
        #: verdict the router consults — a crash is invisible until traffic
        #: runs into it, which is exactly what emergent detection needs.
        self.crashed = False
        #: EWMA of per-item demand service time — the "how fast is this
        #: node lately" signal replica-aware routing steers by
        self.ewma_service: Optional[float] = None
        self._watchers: list[Callable[[Any], None]] = []
        #: chaos injection hook (see ``repro.core.chaos``): when wired, the
        #: RPC entry points below consult the engine for every message that
        #: names its sender via ``src`` — partitions and drops surface as
        #: ``RPCFuture.dropped`` / ``None`` acks, link delay lands on the
        #: completion time.  These entry points are the *only* sanctioned
        #: way for a coordinator to reach this node's channels (palplint
        #: PALP104 flags direct ``Channel.issue`` sends that bypass them).
        self.chaos = None
        self.node_id: Optional[int] = None
        #: Palpascope hook: RPC entry points open child spans on this
        #: tracer.  NULL_TRACER's methods are constant no-ops, so an
        #: untraced store pays a few method calls per RPC and nothing
        #: else (gated by bench_overhead's tracing_overhead_ratio).
        self.tracer = NULL_TRACER

    # channel aliases (pre-futures API surface, kept for tests/tools)
    @property
    def background_free_at(self) -> float:
        return self.background.free_at

    @background_free_at.setter
    def background_free_at(self, t: float) -> None:
        self.background.free_at = t

    @property
    def write_free_at(self) -> float:
        return self.write_channel.free_at

    @write_free_at.setter
    def write_free_at(self, t: float) -> None:
        self.write_channel.free_at = t

    # -- population ------------------------------------------------------
    def load(self, items: Iterable[tuple]) -> None:
        for k, v in items:
            self.data[k] = v

    # -- failure injection ------------------------------------------------
    def crash(self) -> None:
        """Kill the node: in-flight and future RPCs stop acking.  Nothing
        is *declared* anywhere — detection must emerge from traffic."""
        self.crashed = True

    def recover(self) -> None:
        """The process is back (data intact, possibly stale).  Again
        nothing is declared: the cluster notices via probe acks."""
        self.crashed = False

    # -- chaos injection chokepoint ---------------------------------------
    def connect_chaos(self, engine, node_id: int) -> None:
        """Wire a ``ChaosEngine`` onto this node's RPC entry points."""
        self.chaos = engine
        self.node_id = node_id

    def _chaos_send(self, now: float, src) -> tuple[bool, float, int]:
        """Adjudicate one inbound message on the ``src -> this node`` link.

        Returns ``(delivered, entry_time, duplicates)``.  Without a wired
        engine or a named sender the message passes untouched — standalone
        stores and legacy call sites pay nothing for the hook.
        """
        if self.chaos is None or src is None:
            return True, now, 0
        ok, delay, dups = self.chaos.on_send(now, src, self.node_id)
        return ok, now + delay, dups

    # -- foreground (demand) path ----------------------------------------
    def _note_service(self, latency: float, n_items: int) -> None:
        per_item = latency / max(1, n_items)
        if self.ewma_service is None:
            self.ewma_service = per_item
        else:
            self.ewma_service = 0.8 * self.ewma_service + 0.2 * per_item

    def _serve(self, keys: Sequence) -> tuple[list, float]:
        """Look up + sample latency; no EWMA update (shared by the demand
        and background paths — only demand service feeds routing)."""
        vals = [self.data.get(k) for k in keys]
        total = sum(len(v) for v in vals if v is not None)
        self.gets += len(keys)
        self.bytes_served += total
        return vals, self.latency.get(len(keys), total)

    def get(self, key) -> tuple[Any, float]:
        """Returns (value, latency)."""
        vals, lat = self._serve((key,))
        self._note_service(lat, 1)
        return vals[0], lat

    def multi_get(self, keys: Sequence) -> tuple[list, float]:
        vals, lat = self._serve(keys)
        self._note_service(lat, len(keys))
        return vals, lat

    def _trace_rpc(self, sp, now: float, entry: float, done: float,
                   src, dups: int, n_keys: int) -> None:
        """Annotate a delivered demand RPC: chaos link delay/duplication
        as fields, the node-side interval as a ``service`` child (the
        span a chaos-dropped RPC conspicuously lacks)."""
        tr = self.tracer
        sp.set(node=self.node_id, src=src, n_keys=n_keys)
        if entry > now:
            sp.set(link_delay=entry - now)
        if dups:
            sp.set(duplicates=dups)
        ssp = tr.span(SPAN_SERVICE, entry)
        tr.end(ssp, done)
        sp.finish(done)

    def get_async(self, key, now: float, src=None) -> RPCFuture:
        """Issue a demand read on the node's RPC pipeline; never blocks.
        The future's ``done_at`` accounts queueing behind other in-flight
        demand reads (handler-pool contention)."""
        tr = self.tracer
        sp = tr.span(SPAN_RPC, now)
        ok, entry, dups = self._chaos_send(now, src)
        if not ok:
            if sp.live:
                sp.mark("dropped").set(node=self.node_id, src=src,
                                       reason=getattr(self.chaos,
                                                      "last_drop_reason",
                                                      None))
            tr.end(sp, now)
            return RPCFuture((key,), [None], now, now, done_each=[now],
                             timed_out=True, dropped=True)
        v, lat = self.get(key)
        done = self.demand.issue(entry, lat)
        for _ in range(dups):  # duplicate delivery: wasted handler service
            self.demand.issue(entry, lat)
        if sp.live:
            self._trace_rpc(sp, now, entry, done, src, dups, 1)
        tr.end(sp)
        return RPCFuture((key,), [v], now, done, done_each=[done])

    def multi_get_async(self, keys: Sequence, now: float,
                        src=None) -> RPCFuture:
        """Batched demand read as one pipelined RPC."""
        tr = self.tracer
        sp = tr.span(SPAN_RPC, now)
        ok, entry, dups = self._chaos_send(now, src)
        if not ok:
            if sp.live:
                sp.mark("dropped").set(node=self.node_id, src=src,
                                       reason=getattr(self.chaos,
                                                      "last_drop_reason",
                                                      None))
            tr.end(sp, now)
            return RPCFuture(tuple(keys), [None] * len(keys), now, now,
                             done_each=[now] * len(keys),
                             timed_out=True, dropped=True)
        vals, lat = self.multi_get(keys)
        done = self.demand.issue(entry, lat)
        for _ in range(dups):
            self.demand.issue(entry, lat)
        if sp.live:
            self._trace_rpc(sp, now, entry, done, src, dups, len(keys))
        tr.end(sp)
        return RPCFuture(tuple(keys), vals, now, done,
                         done_each=[done] * len(keys))

    def demand_backlog(self, now: float) -> float:
        """Queueing delay a new demand read would see right now."""
        return self.demand.backlog(now)

    def frontier(self) -> float:
        """The furthest virtual time any channel has been driven to — the
        join point for a new client's clock (see :meth:`Clock.sync`)."""
        return max(max(self.demand.lanes), max(self.background.lanes),
                   max(self.write_channel.lanes))

    def contains(self, key) -> bool:
        """Membership probe on store metadata (no data transfer, no latency
        charge — the client library caches the schema/key range map)."""
        return key in self.data

    # -- background channel (prefetch batches, async writes) --------------
    def backlog(self, now: float) -> float:
        """Outstanding work queued on the background channel, in seconds."""
        return self.background.backlog(now)

    def background_get(self, keys: Sequence, now: float,
                       src=None) -> tuple[list, float]:
        """Issue a batched get on the background channel at virtual time
        ``now``; returns (values, completion_time).  Does not touch the
        demand-service EWMA: amortized batch service would make prefetch-
        heavy nodes look faster to demand routing than they are.  A chaos
        drop sheds the whole batch and returns ``(None, now)`` — distinct
        from a backlog-cap shed's ``[None, ...]`` values so the caller can
        feed the missed ack to its failure detector."""
        tr = self.tracer
        sp = tr.span(SPAN_RPC, now)
        ok, entry, _ = self._chaos_send(now, src)
        if not ok:
            if sp.live:
                sp.mark("dropped").set(node=self.node_id, src=src,
                                       background=True)
            tr.end(sp, now)
            return None, now
        vals, lat = self._serve(keys)
        done = self.background.issue(entry, lat)
        if sp.live:
            # background work: the span closes at issue time (it must
            # nest in the foreground op that caused it); the batch's
            # landing time rides along as a field
            sp.set(node=self.node_id, src=src, n_keys=len(keys),
                   background=True, done_at=done)
        tr.end(sp, entry)
        return vals, done

    def background_multi_get(
        self, keys: Sequence, now: float, backlog_cap: Optional[float] = None
    ) -> tuple[list, list]:
        """Store-agnostic prefetch API: batched background get returning
        *per-key* completion times (a sharded store completes each key when
        its owning node's batch lands).  With ``backlog_cap``, a batch whose
        channel is backlogged past the cap is shed (values come back None) —
        bounded I/O amplification, paper §1 'efficient'."""
        if backlog_cap is not None and self.backlog(now) > backlog_cap:
            return [None] * len(keys), [now] * len(keys)
        vals, done = self.background_get(keys, now)
        return vals, [done] * len(keys)

    def put(self, key, value: bytes, now: float, src=None) -> Optional[float]:
        """Async write-behind: returns completion time on the write channel
        (the store's WAL path — writes never contend with prefetch reads);
        the caller does not block.  Returns ``None`` when the chaos engine
        dropped the message — the write never reached this node, the
        coordinator sees a missed ack and must hint/retry."""
        tr = self.tracer
        sp = tr.span(SPAN_RPC, now)
        ok, entry, dups = self._chaos_send(now, src)
        if not ok:
            if sp.live:
                sp.mark("dropped").set(node=self.node_id, src=src,
                                       write=True)
            tr.end(sp, now)
            return None
        self.data[key] = value
        lat = self.latency.put(1, len(value))
        done = self.write_channel.issue(entry, lat)
        for _ in range(dups):  # duplicate delivery: idempotent re-apply
            self.write_channel.issue(entry, lat)
        if sp.live:
            sp.set(node=self.node_id, src=src, write=True, done_at=done)
            if dups:
                sp.set(duplicates=dups)
        tr.end(sp, entry)
        for w in self._watchers:
            w(key)
        return done

    def apply_replica_write(self, key, value: bytes, version,
                            now: float, src=None) -> Optional[float]:
        """Install a *replicated* write — value and version together, as one
        message — on this node's write channel.  This is the sanctioned
        chokepoint for read-repair, hinted-handoff drains, and any other
        coordinator-to-replica transfer (PALP104 flags the direct-channel
        sends this replaces).  Returns the completion time, or ``None``
        when chaos dropped the message (nothing applied)."""
        tr = self.tracer
        sp = tr.span(SPAN_RPC, now)
        ok, entry, dups = self._chaos_send(now, src)
        if not ok:
            if sp.live:
                sp.mark("dropped").set(node=self.node_id, src=src,
                                       replica_write=True)
            tr.end(sp, now)
            return None
        self.data[key] = value
        self.versions[key] = version
        lat = self.latency.put(1, len(value))
        done = self.write_channel.issue(entry, lat)
        for _ in range(dups):
            self.write_channel.issue(entry, lat)
        if sp.live:
            sp.set(node=self.node_id, src=src, replica_write=True,
                   done_at=done)
        tr.end(sp, entry)
        # deliberately no watcher fire: repair/drain installs the value
        # clients already observed at write time — no invalidation storm
        return done

    def bulk_apply(self, items: Sequence[tuple], now: float,
                   src=None) -> Optional[float]:
        """Install a batch of ``(key, value, version)`` records as one
        streamed message on the write channel (membership range transfers).
        One latency charge for the whole batch; ``None`` on a chaos drop
        (the stream batch must be resent)."""
        ok, entry, _ = self._chaos_send(now, src)
        if not ok:
            return None
        nbytes = 0
        for key, value, version in items:
            self.data[key] = value
            self.versions[key] = version
            nbytes += len(value)
        lat = self.latency.put(len(items), nbytes)
        return self.write_channel.issue(entry, lat)

    # -- coherence monitor (co-processor / trigger stand-in, §4.4) --------
    def watch(self, callback: Callable[[Any], None]) -> None:
        """Register a cache-invalidation watcher, as an HBase co-processor
        or Cassandra trigger would notify client caches of updated items."""
        self._watchers.append(callback)
