"""Sharded multi-node Palpatine cluster (beyond-paper scale axis).

Copied from ``src/repro/core/cluster.py``; ``ClusterClient`` takes a
``device`` and builds its tenants, the port's ``PalpatineClient``, with
it, so each tenant mines on that device (default the card).
``ClusterBaseline`` stays on the host.

The paper evaluates one application-level cache in front of one DKV store;
its design (client-side monitoring, a pattern metastore, probabilistic-tree
prefetching) is explicitly meant for *distributed* stores serving many
tenants.  This module scales the simulation out on both sides:

* ``ShardedDKVStore`` — N simulated storage nodes behind a consistent-hash
  ring (virtual nodes for balance).  Each node keeps its own latency model,
  background prefetch channel, write-behind channel, and write monitor, so
  contention, jitter, and coherence traffic are per node, like a real
  region-server fleet.
* ``ShardedTwoSpaceCache`` — a client's cache budget partitioned per shard
  (one two-space LRU per storage node) so a hot shard's churn cannot evict
  another shard's working set, and per-shard hit ratios are observable.
* ``PatternExchange`` — mined patterns gossiped between clients through a
  shared metastore held in *key space* (container keys, not per-client item
  ids), so a cold client benefits from a warm one's mining — the paper's
  metastore (§3.2), scaled out across tenants.
* ``ClusterClient`` / ``ClusterBaseline`` — M concurrent client sessions
  interleaved on their virtual clocks (always step the tenant whose clock
  is furthest behind), with periodic pattern exchange.

MITHRIL mines associations per server and GrASP stresses generalizing
learned patterns across scalable transactional workloads (see PAPERS.md);
the cluster combines both: per-client mining, cluster-wide pattern reuse.
"""

from __future__ import annotations

import bisect
import dataclasses
import heapq
from typing import Callable, Iterable, Optional, Sequence

from .backstore import LatencyModel, RPCFuture, SimulatedDKVStore
from .cache import CacheStats, TwoSpaceCache
from .membership import (
    BudgetRebalancer,
    FailureDetector,
    HintedHandoffLog,
    LeaseTable,
    MembershipEvent,
    MoveReport,
    _hash64,
    add_node as _membership_add_node,
    build_ring,
    drain_node as _membership_drain_node,
    remove_node as _membership_remove_node,
)
from .metastore import PatternMetastore, VerdictBoard
from .mining import Pattern
from .obs import (
    EVENT_HINT,
    EVENT_QUORUM,
    EVENT_READ_REPAIR,
    EVENT_RETRY,
    EVENT_SLOPPY,
    NULL_TRACER,
    SPAN_ROUTE,
    SPAN_WRITE,
    AttributionTable,
)
from .palpatine import BaselineClient, PalpatineClient, PalpatineConfig
from .ptree import PTreeIndex
from .versions import (
    DottedVersion,
    concurrent as _vv_concurrent,
    descends as _vv_descends,
    merge as _vv_merge,
)

__all__ = [
    "ShardedDKVStore",
    "ShardedTwoSpaceCache",
    "PatternExchange",
    "VerdictExchange",
    "ClusterConfig",
    "ClusterClient",
    "ClusterBaseline",
    "sum_stats",
]


def sum_stats(stats: Iterable[CacheStats]) -> CacheStats:
    """Aggregate CacheStats counters (per-shard or per-tenant roll-up)."""
    agg = CacheStats()
    for s in stats:
        for f in dataclasses.fields(CacheStats):
            setattr(agg, f.name, getattr(agg, f.name) + getattr(s, f.name))
    return agg


# ---------------------------------------------------------------------------
# Sharded back store
# ---------------------------------------------------------------------------


class ShardedDKVStore:
    """N simulated storage nodes behind a consistent-hash ring, with R-way
    replication (each key lives on the R distinct ring successors of its
    point — primary first, like Dynamo/Cassandra preference lists).

    Exposes the same client-facing surface as ``SimulatedDKVStore`` (get /
    multi_get / put / load / contains / watch / backlog /
    background_multi_get, plus the futures API get_async / multi_get_async)
    so ``PalpatineClient`` and ``BaselineClient`` run against it unchanged.

    Read semantics are read-one-of-R by default: each demand read routes to
    the replica with the lowest estimated completion time (demand-channel
    backlog + EWMA service) among the replicas holding the key's *newest
    version*, so one degraded node only slows the keys that have no other
    live replica and a stale rejoiner is never served from.  ``read_quorum``
    > 1 issues to every live replica and completes at the q-th fastest.
    Writes stamp a monotone per-key version (the put frontier) on every
    live replica; ``write_mode='all'`` completes at the slowest replica
    ack, ``write_mode='quorum'`` at the majority ack (all live replicas
    still apply).  Down replicas receive *hinted handoffs*, drained on
    ``set_down(shard, False)``; reads that observe version divergence
    perform *read-repair* — together they converge a recovered node to
    byte-identical state (see :mod:`repro.core.membership`).

    The ring is elastic: :meth:`add_node` / :meth:`remove_node` recompute
    preference lists and stream only the owed key ranges (copy-then-prune,
    virtual-clock-costed), while reads keep being served.
    """

    def __init__(self, n_shards: int = 4,
                 latencies: Optional[Sequence[LatencyModel]] = None,
                 vnodes: int = 64, replication: int = 1,
                 read_quorum: int = 1, write_mode: str = "all",
                 read_repair: bool = True,
                 failure_detection: bool = False,
                 sloppy_quorum: bool = False,
                 rpc_timeout: float = 10e-3,
                 detector: Optional[FailureDetector] = None,
                 versioning: str = "dotted",
                 strict_read_quorum: bool = False,
                 record_acks: bool = False):
        if latencies is None:
            latencies = [LatencyModel(seed=1009 + i) for i in range(n_shards)]
        if len(latencies) != n_shards:
            raise ValueError("need one LatencyModel per shard")
        if versioning not in ("dotted", "counter"):
            raise ValueError("versioning must be 'dotted' or 'counter'")
        self.n_shards = int(n_shards)
        self.replication = max(1, min(int(replication), self.n_shards))
        if not 1 <= int(read_quorum) <= self.replication:
            raise ValueError("read_quorum must be in [1, replication]")
        if write_mode not in ("all", "quorum"):
            raise ValueError("write_mode must be 'all' or 'quorum'")
        self.read_quorum = int(read_quorum)
        self.write_mode = write_mode
        self.read_repair = bool(read_repair)
        self.shards = [SimulatedDKVStore(l) for l in latencies]
        self.down: set[int] = set()
        self.removed: set[int] = set()
        self.vnodes = int(vnodes)
        self.hints = HintedHandoffLog()
        self.read_repairs = 0
        #: emergent failure detection: suspicion accrued from missed acks
        #: and service times (None = verdicts come only from ``set_down``)
        self.detector = (detector if detector is not None
                         else FailureDetector() if failure_detection else None)
        #: coordinator-side ack deadline: an RPC to a crashed node expires
        #: after this much virtual time and feeds the detector
        self.rpc_timeout = float(rpc_timeout)
        #: Dynamo sloppy quorums: a write owed to an unavailable preference
        #: replica is handed to the next ring successor (stamped with the
        #: intended owner via the hint log) and its ack counts toward W
        self.sloppy_quorum = bool(sloppy_quorum)
        self.sloppy_writes = 0
        self.rpc_timeouts = 0        # missed acks observed (coordinator)
        self.stale_reads = 0         # served below the global max version
        self.probes = 0              # recovery pings sent to suspects
        #: 'dotted' stamps writes with dotted version vectors (per-
        #: coordinator dots, sibling detection, deterministic LWW-by-dot
        #: merge — partition-tolerant causality); 'counter' is the legacy
        #: monotone int, kept so tests can demonstrate exactly the silent
        #: divergence it suffers under concurrent multi-coordinator writes
        self.versioning = versioning
        #: a strict quorum read refuses (KeyError) instead of degrading
        #: when fewer than R replicas are reachable — the configuration
        #: the W+R>N quorum-safety invariant is checked under
        self.strict_read_quorum = bool(strict_read_quorum)
        #: chaoscheck support: remember every acked write as (key, version,
        #: value) so the causality invariant ("no acked write lost") has a
        #: ground truth to audit the healed cluster against
        self.record_acks = bool(record_acks)
        self.acked_writes: list[tuple] = []
        self.siblings_detected = 0   # concurrent-version reads observed
        self.sibling_merges = 0      # deterministic LWW-by-dot resolutions
        #: deterministic fault injection (repro.core.chaos); None = calm
        self.chaos = None
        #: Palpascope tracer (repro.core.obs); NULL_TRACER = off, free
        self.tracer = NULL_TRACER
        #: this coordinator's identity: dots are (counter, coord_id) pairs
        #: and the chaos engine addresses coordinators as "c<id>"
        self.coord_id = 0
        self._coordinators = [self]
        #: local mirror of the cluster-wide failure-verdict board
        #: (VerdictExchange gossips these between coordinators)
        self.verdict_board = VerdictBoard()
        self._write_version = 0
        self._watchers: list[Callable] = []
        self._membership_watchers: list[Callable] = []
        self._points, self._owners = build_ring(
            range(self.n_shards), self.vnodes)
        self._replica_cache: dict = {}
        #: (points, owners, cache) of each in-flight ring while membership
        #: changes stream their ranges: writes apply to the union of the
        #: installed and every pending ring's owners (Cassandra's
        #: pending-range writes), so an acked mid-move write can never be
        #: destroyed by the post-cutover prune
        self._pending_rings: list[tuple] = []
        #: keys written during a streaming window — the cutover sweeps
        #: their old-ring-only copies (keys absent from the pre-move
        #: resident snapshot would otherwise leak orphans on non-owners)
        self._pending_writes: set = set()
        #: range-transfer leases: overlapping membership changes are
        #: admitted concurrently iff their moved key sets are disjoint
        self.leases = LeaseTable()
        self._held_leases: list = []
        self._deferred_changes: list = []
        self._membership_depth = 0

    @property
    def write_quorum(self) -> int:
        """Acks a quorum write completes at: a replica majority (W), so
        W + R > N holds whenever read_quorum is also a majority."""
        return self.replication // 2 + 1

    @property
    def coord_name(self) -> str:
        """This coordinator's chaos-engine endpoint id."""
        return f"c{self.coord_id}"

    # -- chaos wiring ------------------------------------------------------
    def enable_chaos(self, engine) -> None:
        """Install a :class:`~repro.core.chaos.ChaosEngine` on this cluster:
        every coordinator front-end consults it for partitions, and every
        storage node adjudicates inbound RPCs through it (drop / delay /
        duplicate on the ``coordinator -> node`` link)."""
        for c in self._coordinators:
            c.chaos = engine
        for i, s in enumerate(self.shards):
            s.connect_chaos(engine, i)

    def enable_tracing(self, tracer) -> None:
        """Install a :class:`~repro.core.obs.Tracer` on this cluster:
        coordinator front-ends open routing/write spans and every storage
        node opens RPC/service spans nested inside them (same wiring shape
        as :meth:`enable_chaos`)."""
        for c in self._coordinators:
            c.tracer = tracer
        for s in self.shards:
            s.tracer = tracer

    def _chaos_tick(self, now: float) -> None:
        """Advance the fault timeline to ``now`` (op-driven, so crash
        windows flip deterministically on the virtual clock)."""
        if self.chaos is not None:
            self.chaos.advance(now, self.shards)

    def _partitioned(self, shard: int, now: Optional[float]) -> bool:
        """Is the ``this coordinator -> shard`` direction cut right now?"""
        return (self.chaos is not None and now is not None
                and self.chaos.partitioned(now, self.coord_name, shard))

    # -- placement ---------------------------------------------------------
    def shard_of(self, key) -> int:
        """Primary node: first virtual node clockwise from the key's point."""
        return self.replicas_of(key)[0]

    def replicas_of(self, key) -> tuple[int, ...]:
        """The key's preference list: R distinct nodes walking the ring
        clockwise from its point (primary first)."""
        return self._ring_replicas(key, self._points, self._owners,
                                   self._replica_cache)

    def _ring_replicas(self, key, points, owners_ring, cache
                       ) -> tuple[int, ...]:
        h = _hash64(key)
        cached = cache.get(h)
        if cached is not None:
            return cached
        i = bisect.bisect_right(points, h) % len(points)
        owners: list[int] = []
        for step in range(len(owners_ring)):
            s = owners_ring[(i + step) % len(owners_ring)]
            if s not in owners:
                owners.append(s)
                if len(owners) == self.replication:
                    break
        reps = tuple(owners)
        cache[h] = reps
        return reps

    def _write_targets(self, key) -> list[int]:
        """Nodes a write must reach: the installed preference list, plus —
        while membership changes are streaming — each pending ring's
        owners of the key, so the post-cutover prune can never destroy an
        acked mid-move write."""
        targets = list(self.replicas_of(key))
        for pts, own, cch in self._pending_rings:
            for s in self._ring_replicas(key, pts, own, cch):
                if s not in targets:
                    targets.append(s)
        return targets

    # -- failure verdicts --------------------------------------------------
    def _suspected(self, shard: int) -> bool:
        return self.detector is not None and self.detector.suspected(shard)

    def _unavailable(self, shard: int, now: Optional[float] = None) -> bool:
        """The router's availability picture: declared down (``set_down``),
        suspected by the failure detector, or — when a chaos engine is
        wired and the caller knows the time — on the far side of an active
        partition.  A crashed-but-unsuspected node is NOT here — its
        failure is only discoverable by paying the ack timeout, which is
        exactly how the detector learns."""
        return (shard in self.down or self._suspected(shard)
                or self._partitioned(shard, now))

    def _failed(self, shard: int) -> bool:
        """The transfer coordinator's view (membership streaming): it
        observes its own timeouts synchronously, so a crashed node is a
        failed source/destination even before the detector's verdict."""
        return self._unavailable(shard) or self.shards[shard].crashed

    def _note_ack(self, shard: int, service: Optional[float] = None) -> None:
        if self.detector is not None and \
                self.detector.observe_ack(shard, service):
            # the ack cleared a standing suspicion: emergent rejoin —
            # hand the node's hinted writes back
            self._drain_hints(shard)

    def _note_timeout(self, shard: int) -> None:
        self.rpc_timeouts += 1
        if self.detector is not None:
            self.detector.observe_timeout(shard)

    def _maybe_probe(self, now: float) -> None:
        """Ping suspects every ``probe_every``-th op (op-driven, so it is
        deterministic on the virtual clock).  A crashed suspect keeps
        missing acks; a recovered one acks, and ``clear_acks`` consecutive
        probe acks revoke the verdict and drain its hints — recovery is as
        emergent as detection, no ``set_down(shard, False)`` required."""
        det = self.detector
        if det is None:
            return
        for s in sorted(det.suspects()):
            if s in self.down or s in self.removed:
                continue          # declared down: recovery is explicit
            if not det.should_probe(s):
                continue
            self.probes += 1
            if self.shards[s].crashed or self._partitioned(s, now):
                det.observe_timeout(s)
            elif det.observe_ack(s):
                self._drain_hints(s, now)

    def set_down(self, shard: int, down: bool = True,
                 now: Optional[float] = None) -> int:
        """Mark a node failed/recovered — the *declared* override (tests,
        operators); the failure detector reaches the same verdicts from
        traffic alone.  Reads route around down replicas; writes leave
        them *hinted handoffs*.  Recovery (``down=False``) clears any
        standing suspicion and drains the node's hints on its write
        channel (anti-entropy re-sync), returning the replayed count."""
        if down:
            self.down.add(shard)
            return 0
        self.down.discard(shard)
        if self.detector is not None:
            self.detector.reset(shard)
        return self._drain_hints(shard, now)

    def _drain_hints(self, shard: int, now: Optional[float] = None) -> int:
        """Replay the recovered node's hinted handoffs on its write channel
        (through the :meth:`~repro.core.backstore.SimulatedDKVStore.
        apply_replica_write` chokepoint, so an active chaos schedule can
        still drop individual replays — undelivered hints go back on the
        log, conserved, and a later drain retries them).

        Keys the node already holds at a *descendant* version (a
        read-repair won the race) are skipped as superseded; a hint that
        is a causal sibling of the node's current version (the node took
        a write from the other side of a partition while this hint
        waited) is resolved by the deterministic LWW-by-dot merge before
        it lands.  Hints carried by a sloppy-quorum *holder* hand the key
        back: once the owner has it, the holder's stray copy is pruned —
        unless the holder is itself unreachable mid-drain, in which case
        the whole hint is deferred (hand-back needs both ends).  No
        watcher storm: each hinted write already fired the cluster's
        coherence watchers from its live replicas at write time."""
        pending = self.hints.take(shard)
        if not pending:
            return 0
        node = self.shards[shard]
        t = self.frontier() if now is None else float(now)
        replayed = 0
        for k in sorted(pending, key=repr):
            value, ver, holder = pending[k]
            if holder is not None and holder not in self.replicas_of(k):
                if (self.shards[holder].crashed
                        or self._partitioned(holder, now)):
                    # the hand-back's prune side is unreachable: defer the
                    # whole hint (owner landing + holder prune are one
                    # logical hand-back; half of it would strand a stray
                    # copy that could serve divergent reads)
                    self.hints.restore(shard, k, pending[k])
                    continue
                # hand-back: the holder only kept the copy to back this
                # hint; once processed it must not serve the key again
                if self.shards[holder].data.pop(k, None) is not None:
                    self.shards[holder].versions.pop(k, None)
            if shard not in self.replicas_of(k):
                # a ring change re-homed the key while the node was down:
                # replaying would re-materialize a copy its new owners
                # already hold
                self.hints.superseded += 1
                continue
            if k in node.data:
                cur = node.versions.get(k, 0)
                if _vv_descends(cur, ver):
                    # a read-repair already converged this key
                    self.hints.superseded += 1
                    continue
                if self.versioning == "dotted" and _vv_concurrent(cur, ver):
                    # partition siblings: the node wrote while this hint
                    # waited — deterministic LWW-by-dot, merged clock
                    # keeps both dots in causal history
                    merged = _vv_merge([cur, ver])
                    if ver >= cur:      # hint's dot wins: its value lands
                        value = value
                    else:               # node's own write wins the value
                        value = node.data[k]
                    ver = merged
                    self.sibling_merges += 1
            done = node.apply_replica_write(k, value, ver, t,
                                            src=self.coord_name)
            if done is None:
                # chaos dropped the replay: the obligation stands
                self._note_timeout(shard)
                self.hints.restore(shard, k, pending[k])
                continue
            replayed += 1
        self.hints.replayed += replayed
        return replayed

    def _walk_ring(self, key):
        """Every distinct live ring owner clockwise from the key's point
        (the preference list is this walk's first R entries)."""
        h = _hash64(key)
        i = bisect.bisect_right(self._points, h) % len(self._points)
        seen: set[int] = set()
        for step in range(len(self._owners)):
            s = self._owners[(i + step) % len(self._owners)]
            if s not in seen:
                seen.add(s)
                yield s

    def _sloppy_holders(self, key, now: Optional[float] = None) -> list[int]:
        """Ring successors beyond the preference list holding a sloppy
        copy of the key — the read path of last resort when every
        preference replica is unavailable."""
        pref = set(self.replicas_of(key))
        return [s for s in self._walk_ring(key)
                if s not in pref and not self._unavailable(s, now)
                and not self.shards[s].crashed
                and self.shards[s].contains(key)]

    def _live_replicas(self, key, exclude: Sequence[int] = (),
                       now: Optional[float] = None) -> list[int]:
        reps = [s for s in self.replicas_of(key)
                if not self._unavailable(s, now) and s not in exclude]
        if not reps and self.sloppy_quorum:
            reps = [s for s in self._sloppy_holders(key, now)
                    if s not in exclude]
        if not reps:
            raise KeyError(f"all replicas of {key!r} are down")
        return reps

    def _repair(self, key, stale: Sequence[int], value, ver,
                now: float) -> None:
        """Read-repair: overwrite stale replicas from a fresh peer through
        the :meth:`~repro.core.backstore.SimulatedDKVStore.
        apply_replica_write` chokepoint (value + version as one message,
        costed on each stale node's write channel, chaos-adjudicated).
        Crashed or partitioned replicas are skipped (nothing can land on
        them; hinted handoff / a later read-repair converges them), and a
        chaos-dropped repair just feeds the detector — the next read
        observes the same divergence and retries.  Watchers stay quiet —
        the repaired value is the one clients already observe through the
        fresh replicas."""
        if value is None:
            return
        for s in stale:
            node = self.shards[s]
            if node.crashed or self._partitioned(s, now):
                continue
            if node.apply_replica_write(key, value, ver, now,
                                        src=self.coord_name) is None:
                self._note_timeout(s)
                continue
            self.read_repairs += 1
            self.tracer.event(EVENT_READ_REPAIR, now, node=s, key=repr(key))

    def _fresh_replicas(self, key, now: float,
                        exclude: Sequence[int] = ()) -> list[int]:
        """Live replicas holding the key's newest version (the version
        probe is metadata, latency-free like :meth:`contains`).  Observed
        divergence — a replica that rejoined before its hints landed —
        triggers read-repair when enabled, so a single read converges the
        key across its preference list.  Under dotted versioning, replicas
        holding causally *concurrent* versions (partition siblings) are
        detected and resolved deterministically: the LWW-by-dot winner's
        value lands everywhere, stamped with the merged clock that carries
        both dots — no sibling silently dropped from causal history.
        ``exclude`` drops replicas the caller already timed out on: the
        result is then the freshest still-*reachable* set (availability
        over freshness)."""
        reps = self._live_replicas(key, exclude, now)
        if len(reps) == 1:
            return reps
        # a replica that does not hold the key at all is staler than any
        # holder (version -1 < 0): a rejoiner owed a version-0 range copy
        # whose hints were lost gets re-replicated by read-repair too
        vers = [self.shards[s].versions.get(key, 0)
                if key in self.shards[s].data else -1 for s in reps]
        vmax = max(vers)
        if min(vers) == vmax:
            return reps
        fresh = [s for s, v in zip(reps, vers) if v == vmax]
        if self.versioning == "dotted":
            dotted = [v for v in vers if isinstance(v, DottedVersion)]
            if any(_vv_concurrent(v, vmax) for v in dotted):
                # partition siblings observed on the read path: merge now
                self.siblings_detected += 1
                merged = _vv_merge(dotted)
                sources = [s for s in fresh if not self.shards[s].crashed]
                if self.read_repair and sources:
                    self._repair(
                        key, [s for s, v in zip(reps, vers) if v != vmax],
                        self.shards[sources[0]].data.get(key), merged, now)
                    self.sibling_merges += 1
                for s in fresh:
                    # metadata-only clock upgrade: the winning value is
                    # already in place, only its causal history widens
                    self.shards[s].versions[key] = merged
                return fresh
        sources = [s for s in fresh if not self.shards[s].crashed]
        if self.read_repair and sources:
            self._repair(key, [s for s, v in zip(reps, vers) if v < vmax],
                         self.shards[sources[0]].data.get(key), vmax, now)
        return fresh

    def _best_of(self, reps: Sequence[int], now: float) -> int:
        """The replica with the lowest estimated completion time —
        demand-channel queueing delay plus the node's EWMA per-item
        service (how slow it has been lately)."""
        if len(reps) == 1:
            return reps[0]
        return min(reps, key=lambda s: (
            self.shards[s].demand_backlog(now)
            + (self.shards[s].ewma_service or 0.0)))

    def _pick_serving(self, key, now: float) -> tuple[int, float, int]:
        """Read-one-of-R routing with missed-ack handling: route to the
        best fresh replica; if it turns out to be crashed the RPC expires
        at ``rpc_timeout`` (the detector hears the miss) and the read
        retries the next candidate.  When every fresh replica times out,
        the freshest *reachable* copy is served instead (a counted stale
        read — availability over freshness, Dynamo-style).  Returns
        ``(node, waited, retries)`` where ``waited`` is the timeout delay
        already paid before the winning RPC could issue."""
        tried: set[int] = set()
        waited = 0.0
        while True:
            fresh = self._fresh_replicas(key, now + waited, exclude=tried)
            pick = self._best_of(fresh, now + waited)
            if self.shards[pick].crashed or \
                    self._partitioned(pick, now + waited):
                self._note_timeout(pick)
                tried.add(pick)
                waited += self.rpc_timeout
                continue
            if tried:
                vmax = max(self.shards[s].versions.get(key, 0)
                           if key in self.shards[s].data else -1
                           for s in self._live_replicas(key,
                                                        now=now + waited))
                if self.shards[pick].versions.get(key, 0) < vmax:
                    self.stale_reads += 1
            return pick, waited, len(tried)

    def _group(self, keys: Sequence, now: float = 0.0,
               exclude: Sequence[int] = ()) -> dict[int, list[int]]:
        """Demand scatter plan: positions per chosen serving node.

        Planning is load-aware: items already assigned to a node during
        this plan count as pending service, so a replicated batch spreads
        across its replicas instead of herding onto whichever node looked
        (marginally) fastest at plan time — a slow replica still receives
        work in inverse proportion to its service estimate."""
        by_shard: dict[int, list[int]] = {}
        pending: dict[int, int] = {}
        for pos, k in enumerate(keys):
            reps = self._fresh_replicas(k, now, exclude)
            if len(reps) == 1:
                s = reps[0]
            else:
                s = min(reps, key=lambda r: (
                    self.shards[r].demand_backlog(now)
                    + (self.shards[r].ewma_service or 1e-6)
                    * (1 + pending.get(r, 0))))
            by_shard.setdefault(s, []).append(pos)
            pending[s] = pending.get(s, 0) + 1
        return by_shard

    # -- population --------------------------------------------------------
    def load(self, items: Iterable[tuple]) -> None:
        for k, v in items:
            for s in self.replicas_of(k):
                # palplint: disable=PALP103 -- bulk preload before any
                # write traffic: absent version means 0 by contract
                self.shards[s].data[k] = v

    def contains(self, key) -> bool:
        return any(self.shards[s].contains(key)
                   for s in self.replicas_of(key)
                   if not self._unavailable(s) and not self.shards[s].crashed)

    # -- foreground (demand) path ------------------------------------------
    def get(self, key) -> tuple:
        pick, waited, _ = self._pick_serving(key, 0.0)
        value, lat = self.shards[pick].get(key)
        self._note_ack(pick, lat)
        return value, waited + lat

    def get_async(self, key, now: float) -> RPCFuture:
        """Futures-based demand read with replica-aware routing.  A read
        that lands on a crashed (not-yet-suspected) replica expires at the
        coordinator's ``rpc_timeout``, feeds the failure detector, and
        retries the next candidate — so the first few reads after a crash
        pay the timeout and every later one routes around it.  With a
        read quorum, issue to every live replica and complete at the q-th
        fastest ack (read amplification buys tail-latency insurance); the
        value always comes from a replica holding the newest version, so
        W + R > N reads are never stale."""
        self._chaos_tick(now)
        self._maybe_probe(now)
        tr = self.tracer
        sp = tr.start(SPAN_ROUTE, now)
        if sp.live:
            sp.set(op="get", key=repr(key), coord=self.coord_name,
                   shard=self.shard_of(key))
        try:
            if self.read_quorum <= 1:
                waited, retries, drops = 0.0, 0, 0
                while True:
                    pick, w, r = self._pick_serving(key, now + waited)
                    waited += w
                    retries += r
                    fut = self.shards[pick].get_async(key, now + waited,
                                                      src=self.coord_name)
                    if not fut.dropped:
                        break
                    # chaos ate the RPC: the coordinator waits out its ack
                    # deadline (rpc_timeout), feeds the detector, and retries
                    # the routing decision — capped so a link dropping 100%
                    # still terminates (as unavailability, not a hang)
                    self._note_timeout(pick)
                    waited += self.rpc_timeout
                    tr.event(EVENT_RETRY, now + waited, node=pick)
                    retries += 1
                    drops += 1
                    if drops >= 8:
                        raise KeyError(
                            f"read of {key!r} dropped {drops} times")
                self._note_ack(pick, fut.done_at - (now + waited))
                fut.node = pick
                fut.issue_time = now
                fut.retries = retries
                fut.timed_out = retries > 0
                if sp.live:
                    sp.set(node=pick, retries=retries, waited=waited)
                sp.finish(fut.done_at)
                return fut
            live, expired, waited_out = self._quorum_candidates(key, now)
            for s in expired:
                self._note_timeout(s)
            fresh = set(self._fresh_replicas(key, now, exclude=expired))
            futs = {}
            dropped = []
            for s in live:
                f = self.shards[s].get_async(key, now, src=self.coord_name)
                if f.dropped:
                    # a lost quorum leg: one detector miss, the read degrades
                    # to the legs that acked (and waits out the ack deadline)
                    self._note_timeout(s)
                    dropped.append(s)
                    continue
                futs[s] = f
                self._note_ack(s, f.done_at - now)
            expired = list(expired) + dropped
            waited_out = waited_out or bool(dropped)
            if not futs:
                raise KeyError(
                    f"no replica of {key!r} acked the quorum read")
            if self.strict_read_quorum and len(futs) < self.read_quorum:
                raise KeyError(
                    f"strict quorum read of {key!r}: {len(futs)} acks "
                    f"< R={self.read_quorum}")
            responders = fresh & set(futs)
            if not responders:
                # every fresh replica's leg was lost: strict mode refuses,
                # default mode serves the freshest *responder* (counted
                # stale)
                if self.strict_read_quorum:
                    raise KeyError(
                        f"strict quorum read of {key!r} lost every fresh "
                        f"replica")
                self.stale_reads += 1
                responders = set(futs)
            q = min(self.read_quorum, len(futs))
            best = min(responders, key=lambda s: futs[s].done_at)
            # complete at the q-th fastest ack, but never before the replica
            # that supplied the value acks: when only a slow rejoiner holds
            # the newest version, the fresh read costs that replica's latency
            # (the degraded-window tail this subsystem is measured on).  A
            # quorum left short by crashed replicas waits out their timeout.
            done = max(sorted(f.done_at for f in futs.values())[q - 1],
                       futs[best].done_at)
            if waited_out:
                done = max(done, now + self.rpc_timeout)
            tr.event(EVENT_QUORUM, done, q=q, acks=len(futs),
                     lost=len(expired))
            if sp.live:
                sp.set(node=best, retries=len(expired))
            sp.finish(done)
            return RPCFuture((key,), futs[best].values, now, done,
                             done_each=[done], node=best,
                             timed_out=bool(expired), retries=len(expired))
        except BaseException:
            sp.mark("error")
            raise
        finally:
            tr.end(sp)

    def _scatter_read_one(self, keys: Sequence, now: float,
                          fetch: Callable) -> tuple[list, list, int]:
        """Shared read-one scatter loop with missed-ack retry: plan each
        key onto its best fresh replica, expire whole sub-batches landing
        on a crashed node (one detector miss per node, one ``rpc_timeout``
        per round), and re-plan the expired keys among the survivors.
        ``fetch(shard, sub_keys, t) -> (values, done_at)`` issues one
        sub-batch; returns ``(values, done_each, retry_rounds)``."""
        vals: list = [None] * len(keys)
        done_each: list = [now] * len(keys)
        remaining = list(enumerate(keys))
        excluded: set[int] = set()
        rounds = 0
        while remaining:
            t = now + rounds * self.rpc_timeout
            sub_keys = [k for _, k in remaining]
            plan = self._group(sub_keys, t, exclude=excluded)
            retry: list = []
            for shard, positions in sorted(plan.items()):
                if self.shards[shard].crashed or self._partitioned(shard, t):
                    self._note_timeout(shard)
                    excluded.add(shard)
                    retry.extend(remaining[p] for p in positions)
                    continue
                sub_vals, done_at = fetch(
                    shard, [sub_keys[p] for p in positions], t)
                if sub_vals is None:
                    # chaos dropped the whole sub-batch: wait out the ack
                    # deadline and re-plan its keys among the survivors
                    self._note_timeout(shard)
                    excluded.add(shard)
                    retry.extend(remaining[p] for p in positions)
                    continue
                self._note_ack(shard, done_at - t)
                for p, v in zip(positions, sub_vals):
                    pos = remaining[p][0]
                    vals[pos] = v
                    done_each[pos] = done_at
            remaining = retry
            rounds += 1
        return vals, done_each, max(0, rounds - 1)

    def _quorum_candidates(self, key, now: Optional[float] = None
                           ) -> tuple[list[int], list[int], bool]:
        """A quorum read's reachable candidates: the live preference
        replicas, or — when every one of them is crashed and sloppy
        quorums are on — the ring successors holding a sloppy copy.
        Returns ``(reachable, crashed_replicas, waited_out)`` where
        ``waited_out`` flags a quorum left short by *crashes* (the
        coordinator really waited the ack timeout; a quorum short only
        because of declared-down replicas waited on nothing)."""
        reps = self._live_replicas(key, now=now)
        dead = [s for s in reps if self.shards[s].crashed]
        live = [s for s in reps if not self.shards[s].crashed]
        waited_out = bool(dead) and len(live) < self.read_quorum
        if not live and self.sloppy_quorum:
            live = self._sloppy_holders(key, now)
        if not live:
            raise KeyError(f"all replicas of {key!r} are down")
        return live, dead, waited_out

    def multi_get_async(self, keys: Sequence, now: float) -> RPCFuture:
        """Scatter-gather demand read: one pipelined sub-batch RPC per
        serving node, all in flight concurrently.  Read-one: each key joins
        its routed replica's sub-batch; sub-batches landing on a crashed
        node expire at ``rpc_timeout`` and their keys re-plan among the
        remaining replicas (one detector miss per crashed node).
        Read-quorum: each key joins every live replica's sub-batch (the
        sloppy holders', when every preference replica is crashed) and
        completes at the q-th fastest of its replicas' batches.  The
        future's ``done_at`` is the slowest per-key completion."""
        self._chaos_tick(now)
        self._maybe_probe(now)
        tr = self.tracer
        sp = tr.start(SPAN_ROUTE, now)
        if sp.live:
            sp.set(op="multi_get", n=len(keys), coord=self.coord_name)
        try:
            return self._multi_get_async(keys, now, tr, sp)
        except BaseException:
            sp.mark("error")
            raise
        finally:
            tr.end(sp)

    def _multi_get_async(self, keys: Sequence, now: float, tr, sp
                         ) -> RPCFuture:
        """The scatter body of :meth:`multi_get_async`, inside its
        routing span."""
        if self.read_quorum <= 1:
            def fetch(shard, sub_keys, t):
                fut = self.shards[shard].multi_get_async(
                    sub_keys, t, src=self.coord_name)
                if fut.dropped:
                    return None, None
                return fut.values, fut.done_at
            vals, done_each, retries = self._scatter_read_one(
                keys, now, fetch)
            worst = max(done_each, default=now)
            if sp.live:
                sp.set(retries=retries)
            sp.finish(worst)
            return RPCFuture(tuple(keys), vals, now, worst,
                             done_each=done_each,
                             timed_out=retries > 0, retries=retries)
        vals: list = [None] * len(keys)
        plan = {}
        fresh_of: list[set] = []
        short: list[bool] = []   # quorum short because of *crashes* only
        expired: set[int] = set()
        for pos, k in enumerate(keys):
            live, dead, waited_out = self._quorum_candidates(k, now)
            expired.update(dead)
            short.append(waited_out)
            fresh_of.append(set(self._fresh_replicas(k, now, exclude=dead)))
            for s in live:
                plan.setdefault(s, []).append(pos)
        for s in sorted(expired):
            self._note_timeout(s)
        done_lists: list[list[float]] = [[] for _ in keys]
        fresh_done: list[list[float]] = [[] for _ in keys]
        backup: list = [None] * len(keys)
        for shard, positions in sorted(plan.items()):
            fut = self.shards[shard].multi_get_async(
                [keys[p] for p in positions], now, src=self.coord_name)
            if fut.dropped:
                # chaos ate the sub-batch: every key on it waits out the
                # ack deadline; the detector hears one miss per node
                self._note_timeout(shard)
                expired.add(shard)
                for p in positions:
                    short[p] = True
                continue
            self._note_ack(shard, fut.done_at - now)
            for p, v in zip(positions, fut.values):
                if shard in fresh_of[p]:
                    vals[p] = v
                    fresh_done[p].append(fut.done_at)
                elif backup[p] is None:
                    backup[p] = v
                done_lists[p].append(fut.done_at)
        q = self.read_quorum
        for p, k in enumerate(keys):
            if not done_lists[p]:
                raise KeyError(f"no replica of {k!r} acked the quorum read")
            if not fresh_done[p]:
                # every fresh leg was lost mid-flight: strict mode
                # refuses, default mode degrades (counted stale)
                if self.strict_read_quorum:
                    raise KeyError(
                        f"strict quorum read of {k!r} lost every fresh "
                        f"replica")
                vals[p] = backup[p]
                self.stale_reads += 1
            elif self.strict_read_quorum and len(done_lists[p]) < q:
                raise KeyError(
                    f"strict quorum read of {k!r}: {len(done_lists[p])} "
                    f"acks < R={q}")
        # per key: q-th fastest ack, floored at the earliest *fresh*
        # sub-batch ack (the value cannot land before a holder of the
        # newest version has responded); a quorum left short by crashed
        # replicas waits out their timeout — a quorum short only because
        # of *declared*-down replicas waited on nothing
        done_each = [max(sorted(ds)[min(q, len(ds)) - 1],
                         min(fd, default=now),
                         now + self.rpc_timeout if was_short else now)
                     if ds else now
                     for ds, fd, was_short
                     in zip(done_lists, fresh_done, short)]
        worst = max(done_each, default=now)
        tr.event(EVENT_QUORUM, worst, q=q, lost=len(expired))
        if sp.live:
            sp.set(retries=len(expired))
        sp.finish(worst)
        return RPCFuture(tuple(keys), vals, now, worst, done_each=done_each,
                         timed_out=bool(expired), retries=len(expired))

    def multi_get(self, keys: Sequence) -> tuple[list, float]:
        """Scatter-gather: per-node sub-batches run in parallel; the caller
        waits for the slowest node.  Sub-batches on a crashed node expire
        and re-plan, like :meth:`multi_get_async`."""
        def fetch(shard, sub_keys, t):
            sub, lat = self.shards[shard].multi_get(sub_keys)
            return sub, t + lat
        vals, done_each, _ = self._scatter_read_one(keys, 0.0, fetch)
        return vals, max(done_each, default=0.0)

    # -- background channels -----------------------------------------------
    def backlog(self, now: float) -> float:
        """Least-loaded available node's backlog: prefetching is only fully
        shed when *every* node's background channel is saturated (per-node
        shedding happens inside :meth:`background_multi_get`).  Suspected
        nodes are no more available to prefetching than declared-down
        ones."""
        return min(s.backlog(now) for i, s in enumerate(self.shards)
                   if i not in self.removed and not self._unavailable(i, now))

    def background_multi_get(
        self, keys: Sequence, now: float, backlog_cap: Optional[float] = None
    ) -> tuple[list, list]:
        """Split the batch per least-backlogged replica (load-aware, like
        :meth:`_group`); each node serves its sub-batch on its own
        background channel (concurrently across nodes), so every key
        completes when *its* node's batch lands.  Nodes backlogged past
        ``backlog_cap`` shed their sub-batch only.  A sub-batch placed on
        a crashed node is shed too — prefetches are best-effort and never
        retried — but its missed ack still feeds the failure detector."""
        self._chaos_tick(now)
        vals: list = [None] * len(keys)
        done: list = [now] * len(keys)
        by_shard: dict[int, list[int]] = {}
        pending: dict[int, int] = {}
        for pos, k in enumerate(keys):
            try:
                reps = self._fresh_replicas(k, now)
            except KeyError:
                continue                    # unreachable: shed this key
            if len(reps) == 1:
                s = reps[0]
            else:
                s = min(reps, key=lambda r: (
                    self.shards[r].backlog(now)
                    + (self.shards[r].ewma_service or 1e-6)
                    * (1 + pending.get(r, 0))))
            by_shard.setdefault(s, []).append(pos)
            pending[s] = pending.get(s, 0) + 1
        for shard, positions in sorted(by_shard.items()):
            node = self.shards[shard]
            if node.crashed or self._partitioned(shard, now):
                self._note_timeout(shard)
                continue
            if backlog_cap is not None and node.backlog(now) > backlog_cap:
                continue
            sub, done_at = node.background_get(
                [keys[p] for p in positions], now, src=self.coord_name)
            if sub is None:
                # chaos dropped the prefetch batch: best-effort, never
                # retried — but the missed ack still feeds the detector
                self._note_timeout(shard)
                continue
            self._note_ack(shard)
            for p, v in zip(positions, sub):
                vals[p] = v
                done[p] = done_at
        return vals, done

    def _add_hint(self, owner: int, key, value: bytes, ver: int,
                  holder: Optional[int] = None) -> None:
        """Record a hinted handoff, pruning the stray copy of any
        superseded hint's previous holder (the new write replaces it; a
        holder copy without a live hint would linger as an orphan)."""
        old = self.hints.get_hint(owner, key)
        self.hints.add(owner, key, value, ver, holder=holder)
        if old is not None and old[2] is not None and old[2] != holder \
                and old[1] < ver and old[2] not in self.replicas_of(key):
            node = self.shards[old[2]]
            if node.versions.get(key, 0) < ver and \
                    node.data.pop(key, None) is not None:
                node.versions.pop(key, None)

    def _sloppy_substitutes(self, key, failed: Sequence[int],
                            now: Optional[float] = None
                            ) -> list[tuple[int, int]]:
        """Pair each failed preference replica with the next available
        ring successor outside the preference list (Dynamo's sloppy
        quorum).  A crashed candidate costs a missed ack and the walk
        moves on — the coordinator's retry, observed by the detector."""
        pref = set(self.replicas_of(key))
        subs: list[tuple[int, int]] = []
        taken: set[int] = set()
        cands = iter([s for s in self._walk_ring(key)
                      if s not in pref and s not in self.removed])
        for owner in failed:
            for s in cands:
                if s in taken or self._unavailable(s, now):
                    continue
                if self.shards[s].crashed:
                    self._note_timeout(s)
                    continue
                taken.add(s)
                subs.append((owner, s))
                break
        return subs

    def _next_version(self, key, targets: Sequence[int]):
        """Stamp the next write.  ``counter`` mode is the legacy monotone
        per-coordinator int — two coordinators racing across a partition
        mint colliding stamps and silently shadow each other's writes
        (tests keep it to demonstrate exactly that).  ``dotted`` mode
        mints a :class:`~repro.core.versions.DottedVersion` whose dot is
        ``(counter, coord_id)`` and whose causal context is the versions
        this write is about to overwrite on its targets: a racing write
        from another coordinator is then *concurrent* — a detectable,
        mergeable sibling instead of a silent casualty."""
        self._write_version += 1
        if self.versioning == "counter":
            return self._write_version
        context = [self.shards[s].versions[key] for s in targets
                   if key in self.shards[s].versions]
        return DottedVersion.stamp(self.coord_id, self._write_version,
                                   context)

    def put(self, key, value: bytes, now: float) -> float:
        """Replicated write, stamped by :meth:`_next_version` (a dotted
        version vector by default; the legacy monotone counter in
        ``versioning='counter'`` mode).  Every *live* replica applies it
        on its own write-behind channel; unavailable replicas — declared
        down, suspected, or across an active chaos partition — get hinted
        handoffs, and a crashed-but-unsuspected replica is discovered by
        its missed ack (one ``rpc_timeout``, fed to the detector) before
        being hinted.  With ``sloppy_quorum``, each failed preference
        replica's write is handed to the next ring successor instead: the
        successor applies it, the hint records it as the *holder*, and
        its ack counts toward W — writes stay available with every
        preference replica out.  The logical write completes at the
        slowest ack (``write_mode='all'``) or the W-th fastest where W is
        a replica majority (``write_mode='quorum'`` — bounded write-tail
        exposure, and with a majority read quorum W + R > N guarantees
        non-stale reads).  An RPC the chaos engine *drops* is discovered
        after the availability check: the replica is hinted, the detector
        hears the miss, and a quorum write left short of W by drops
        raises — the partial application it leaves behind is exactly the
        divergence hinted handoff and read-repair exist to converge."""
        self._chaos_tick(now)
        self._maybe_probe(now)
        tr = self.tracer
        sp = tr.start(SPAN_WRITE, now)
        if sp.live:
            sp.set(key=repr(key), coord=self.coord_name,
                   mode=self.write_mode)
        try:
            ret = self._put(key, value, now, tr)
            sp.finish(ret)
            return ret
        except BaseException:
            sp.mark("error")
            raise
        finally:
            tr.end(sp)

    def _put(self, key, value: bytes, now: float, tr) -> float:
        """The replicated-write body of :meth:`put`, inside its span."""
        pref = list(self.replicas_of(key))
        known_failed = [s for s in pref if self._unavailable(s, now)]
        timed_out = [s for s in pref if s not in known_failed
                     and self.shards[s].crashed]
        live_pref = [s for s in pref if s not in known_failed
                     and s not in timed_out]
        failed = [s for s in pref if s in known_failed or s in timed_out]
        for s in timed_out:
            # the coordinator's missed acks: observed even when the write
            # is then refused — the attempt happened, the detector heard it
            self._note_timeout(s)
        subs = (self._sloppy_substitutes(key, failed, now)
                if self.sloppy_quorum and failed else [])
        # availability checks come BEFORE any state mutates: a failed
        # write must leave no applied copy and no hint behind (a phantom
        # would materialize a write the caller was told never happened)
        if not live_pref and not subs:
            raise KeyError(f"all replicas of {key!r} are down")
        if self.write_mode == "quorum" and \
                len(live_pref) + len(subs) < self.write_quorum:
            raise KeyError(
                f"quorum write to {key!r} unavailable: {len(live_pref)} "
                f"live replicas + {len(subs)} sloppy successors "
                f"< W={self.write_quorum}")
        ver = self._next_version(
            key, live_pref + [sub for _, sub in subs])
        holder_of = {owner: sub for owner, sub in subs}
        acks = []
        quorum_acks = []             # preference + sloppy-successor acks
        dropped_any = False
        for s in self._write_targets(key):
            in_pref = s in set(pref)
            if s in self.down or self._suspected(s) or \
                    self.shards[s].crashed or self._partitioned(s, now):
                if in_pref and s in holder_of:
                    continue         # handled via its sloppy successor below
                self._add_hint(s, key, value, ver)
                tr.event(EVENT_HINT, now, owner=s)
                continue
            done = self.shards[s].put(key, value, now, src=self.coord_name)
            if done is None:
                # chaos dropped the RPC mid-flight: the replica is owed a
                # hint and the detector hears the missed ack
                self._note_timeout(s)
                self._add_hint(s, key, value, ver)
                tr.event(EVENT_HINT, now, owner=s, dropped=True)
                dropped_any = True
                continue
            self.shards[s].versions[key] = ver
            self._note_ack(s)
            acks.append(done)
            if in_pref:
                quorum_acks.append(done)
        for owner, sub in subs:
            # the substitute write can only issue after the coordinator
            # gave up on an unsuspected crash (one timeout window);
            # known-failed owners are skipped upfront at no cost
            t0 = now + self.rpc_timeout if owner in timed_out else now
            done = self.shards[sub].put(key, value, t0, src=self.coord_name)
            if done is None:
                # the sloppy leg itself was dropped: the owner keeps a
                # plain (holderless) hint — nothing landed on the sub
                self._note_timeout(sub)
                self._add_hint(owner, key, value, ver)
                tr.event(EVENT_HINT, t0, owner=owner, dropped=True)
                dropped_any = True
                continue
            self.shards[sub].versions[key] = ver
            self._note_ack(sub)
            self._add_hint(owner, key, value, ver, holder=sub)
            tr.event(EVENT_SLOPPY, done, owner=owner, holder=sub)
            self.sloppy_writes += 1
            acks.append(done)
            quorum_acks.append(done)
        if self._pending_rings:
            self._pending_writes.add(key)
        if timed_out or dropped_any:
            # the write cannot be reported complete before the coordinator
            # stopped waiting on the crashed/dropped replicas' acks
            acks = [max(a, now + self.rpc_timeout) for a in acks] or \
                [now + self.rpc_timeout]
        if self.write_mode == "quorum":
            if len(quorum_acks) < self.write_quorum:
                # drops (discovered only at send time) left the write
                # short of W — partial application stands, hints carry
                # the remainder; the caller hears unavailability
                raise KeyError(
                    f"quorum write to {key!r} lost acks in flight: "
                    f"{len(quorum_acks)} < W={self.write_quorum}")
            # W counts preference-list and sloppy-successor acks only: a
            # fast pending-ring owner (mid-move) must not stand in for a
            # replica majority
            quorum_acks.sort()
            if dropped_any:
                quorum_acks = [max(a, now + self.rpc_timeout)
                               for a in quorum_acks]
            ret = quorum_acks[min(self.write_quorum, len(quorum_acks)) - 1]
        else:
            ret = max(acks)
        if self.record_acks:
            self.acked_writes.append((key, ver, value))
        return ret

    # -- membership (elastic ring; see repro.core.membership) --------------
    def add_node(self, latency: Optional[LatencyModel] = None,
                 now: float = 0.0,
                 on_batch: Optional[Callable[[float], None]] = None
                 ) -> MoveReport:
        """Grow the ring by one node: stream only the owed key ranges to
        it (copy-then-prune, channel-costed) and fire targeted membership
        invalidations.  Returns the streamed-range accounting."""
        node = SimulatedDKVStore(
            latency or LatencyModel(seed=1009 + len(self.shards)))
        return _membership_add_node(self, node, now, on_batch)

    def remove_node(self, shard: int, now: float = 0.0,
                    on_batch: Optional[Callable[[float], None]] = None
                    ) -> MoveReport:
        """Decommission a node (live or crashed); its ranges stream to the
        new successor sets from whichever replicas survive."""
        return _membership_remove_node(self, shard, now, on_batch)

    def drain_node(self, shard: int, now: float = 0.0,
                   on_batch: Optional[Callable[[float], None]] = None
                   ) -> MoveReport:
        """Planned, lease-aware decommission (zero-downtime drain): the
        node must be live — an unreachable node cannot be *drained*, only
        removed — and reads keep being served throughout.  The returned
        report carries ``stale_reads_during``, the count of degraded reads
        observed inside the drain window (zero is the acceptance bar the
        cluster bench asserts)."""
        return _membership_drain_node(self, shard, now, on_batch)

    def watch_membership(self, callback: Callable) -> None:
        """Register a ring-change watcher; called with a MembershipEvent
        after every add/remove completes (clients use it for targeted
        cache invalidation of the remapped keys)."""
        self._membership_watchers.append(callback)

    # -- multi-coordinator front-ends & operator anti-entropy ---------------
    def attach_coordinator(self) -> "ShardedDKVStore":
        """A second coordinator front-end over the *same* storage nodes:
        shared ring, shards, hints-independent routing state — but its own
        failure detector, hint log, write counter, and verdict board, so
        two coordinators across a partition form genuinely independent
        (and divergent) opinions.  Its dots are minted under a fresh
        ``coord_id`` and the chaos engine addresses it as ``c<id>``."""
        peer = ShardedDKVStore.__new__(ShardedDKVStore)
        # shared cluster substrate (same objects, not copies)
        for attr in ("n_shards", "replication", "read_quorum", "write_mode",
                     "read_repair", "shards", "down", "removed", "vnodes",
                     "rpc_timeout", "sloppy_quorum", "versioning",
                     "strict_read_quorum", "record_acks", "_points",
                     "_owners", "_replica_cache", "_pending_rings",
                     "_pending_writes", "leases", "_watchers",
                     "_membership_watchers", "chaos", "tracer",
                     "_coordinators"):
            setattr(peer, attr, getattr(self, attr))
        # per-coordinator state: independent opinions and counters
        peer.detector = (FailureDetector() if self.detector is not None
                         else None)
        peer.hints = HintedHandoffLog()
        peer.verdict_board = VerdictBoard()
        peer.read_repairs = 0
        peer.sloppy_writes = 0
        peer.rpc_timeouts = 0
        peer.stale_reads = 0
        peer.probes = 0
        peer.siblings_detected = 0
        peer.sibling_merges = 0
        peer.acked_writes = []
        peer._write_version = 0
        peer._held_leases = []
        peer._deferred_changes = []
        peer._membership_depth = 0
        peer.coord_id = len(self._coordinators)
        self._coordinators.append(peer)
        return peer

    def restart_coordinator(self, now: float, probe_rounds: int = 3
                            ) -> dict:
        """Crash-restart this coordinator front-end: all soft state
        (detector verdicts, hint log, write counter) is lost, then
        *reconstructed from what the cluster itself can attest* — not
        carried over — so a restart can never resurrect a verdict the
        node's observable state no longer supports:

        * the write counter resumes past the highest counter any replica
          holds for this coordinator's dots (dot monotonicity survives);
        * the detector replays ``probe_rounds`` probe sweeps against the
          live topology (a crashed/partitioned node re-accrues suspicion,
          a live one re-earns trust — no stale verdict survives);
        * hint obligations are rediscovered from the stray sloppy-holder
          copies still physically on the ring: a key held outside its
          preference list is a hand-back in flight, re-hinted to every
          preference owner that is missing it or holds an older version
          (or pruned outright when every owner already caught up).

        Returns the reconstruction accounting."""
        self.hints = HintedHandoffLog()
        if self.detector is not None:
            self.detector = FailureDetector()
        self.verdict_board = VerdictBoard()
        self.acked_writes = []
        # -- dot-counter recovery: scan every replica's version metadata
        top = 0
        for node in self.shards:
            for ver in node.versions.values():
                if isinstance(ver, DottedVersion):
                    top = max(top, ver.counter_of(self.coord_id))
                elif self.versioning == "counter":
                    top = max(top, int(ver))
        self._write_version = top
        # -- detector reconstruction: probe sweeps over the live topology
        probed = 0
        if self.detector is not None:
            for _ in range(max(1, int(probe_rounds))):
                for s in range(len(self.shards)):
                    if s in self.removed or s in self.down:
                        continue
                    probed += 1
                    if self.shards[s].crashed or self._partitioned(s, now):
                        self.detector.observe_timeout(s)
                    else:
                        self.detector.observe_ack(s)
        # -- hint rediscovery: stray copies outside a key's preference
        # list are sloppy hand-backs whose hints died with the restart
        rehinted = 0
        pruned = 0
        for holder in range(len(self.shards)):
            if holder in self.removed:
                continue
            node = self.shards[holder]
            for key in sorted(node.data, key=repr):
                pref = self.replicas_of(key)
                if holder in pref:
                    continue
                ver = node.versions.get(key, 0)
                owed = [o for o in pref
                        if key not in self.shards[o].data
                        or not _vv_descends(
                            self.shards[o].versions.get(key, 0), ver)]
                if owed:
                    for o in owed:
                        self.hints.add(o, key, node.data[key], ver,
                                       holder=holder)
                        rehinted += 1
                else:
                    # every owner already caught up: the stray copy is
                    # the only remnant — prune it, obligation met
                    del node.data[key]
                    node.versions.pop(key, None)
                    pruned += 1
        return {"write_version": self._write_version, "probed": probed,
                "rehinted": rehinted, "pruned": pruned}

    def reconcile(self, now: float) -> dict:
        """Operator anti-entropy pass (the chaos harness's *heal* step):
        probe every node, drain reachable nodes' hints, then sweep
        read-repair over every resident key so all live preference
        replicas converge byte-identically.  Idempotent; returns the
        accounting of what it moved."""
        self._chaos_tick(now)
        replayed = 0
        for s in range(len(self.shards)):
            if s in self.removed or s in self.down:
                continue
            if self.shards[s].crashed or self._partitioned(s, now):
                self._note_timeout(s)
                continue
            if self.detector is not None:
                for _ in range(self.detector.clear_acks):
                    self.detector.observe_ack(s)
            replayed += self._drain_hints(s, now)
        return {"replayed": replayed, "repairs": self.anti_entropy(now)}

    def anti_entropy(self, now: float) -> int:
        """Full read-repair sweep: every key resident anywhere is pushed
        through :meth:`_fresh_replicas` (which repairs divergence and
        merges siblings); returns the repair count of this sweep."""
        keys: set = set()
        for s in range(len(self.shards)):
            if s not in self.removed:
                keys.update(self.shards[s].data)
        before = self.read_repairs
        for k in sorted(keys, key=repr):
            try:
                self._fresh_replicas(k, now)
            except KeyError:
                continue       # every replica unreachable: next pass
        return self.read_repairs - before

    # -- coherence ---------------------------------------------------------
    def watch(self, callback: Callable) -> None:
        """Each node runs its own write monitor; a cluster watcher hears
        writes from all of them (including nodes that join later)."""
        self._watchers.append(callback)
        for s in self.shards:
            s.watch(callback)

    def frontier(self) -> float:
        """Furthest virtual time any node's channels reached — where a
        late-joining client's clock must sync to (:meth:`Clock.sync`)."""
        return max(s.frontier() for s in self.shards)

    # -- aggregate telemetry ----------------------------------------------
    @property
    def gets(self) -> int:
        return sum(s.gets for s in self.shards)

    @property
    def bytes_served(self) -> int:
        return sum(s.bytes_served for s in self.shards)

    def per_shard_gets(self) -> list[int]:
        return [s.gets for s in self.shards]


# ---------------------------------------------------------------------------
# Per-shard two-space cache
# ---------------------------------------------------------------------------


class ShardedTwoSpaceCache:
    """A client's cache budget split into one ``TwoSpaceCache`` per storage
    node.  Palpatine keys its cache by per-client item id; ``key_of`` maps
    an item id back to its container key and ``shard_of`` places the key,
    so each entry lives in (and can only evict from) its shard's partition.
    """

    def __init__(self, n_shards: int, total_bytes: int,
                 preemptive_frac: float,
                 key_of: Callable[[int], object],
                 shard_of: Callable[[object], int]):
        self.preemptive_frac = float(preemptive_frac)
        per_shard = int(total_bytes) // max(1, int(n_shards))
        self.spaces = [TwoSpaceCache(per_shard, preemptive_frac)
                       for _ in range(n_shards)]
        self.key_of = key_of
        self.shard_of = shard_of
        self.dead: set[int] = set()  # partitions of removed ring nodes
        self._placement: dict = {}   # iid -> space (rehomed on ring changes)

    def _space(self, iid) -> TwoSpaceCache:
        space = self._placement.get(iid)
        if space is None:
            space = self.spaces[self.shard_of(self.key_of(iid))]
            self._placement[iid] = space
        return space

    # -- budget coordination (membership.BudgetRebalancer) ----------------
    def budgets(self) -> list[int]:
        """Current main-space byte budget per partition."""
        return [sp.main.capacity for sp in self.spaces]

    def set_budgets(self, mains: Sequence[int]) -> None:
        """Re-split the byte budget across partitions; shrunk partitions
        evict LRU-first immediately."""
        if len(mains) != len(self.spaces):
            raise ValueError("need one budget per partition")
        for sp, b in zip(self.spaces, mains):
            sp.resize(int(b))

    def add_shard(self) -> None:
        """A node joined the ring: carve an equal share out of every *live*
        partition for the newcomer (dead partitions of removed nodes hold
        no budget and must not dilute the split), conserving the total
        byte budget; the rebalancer then adapts shares to traffic."""
        live = [sp for i, sp in enumerate(self.spaces)
                if i not in self.dead]
        m = len(live)
        total = sum(self.budgets())
        for sp in live:
            sp.resize(sp.main.capacity * m // (m + 1))
        self.spaces.append(
            TwoSpaceCache(total - sum(self.budgets()), self.preemptive_frac))

    def drop_shard(self, shard: int) -> None:
        """A node left the ring: fold the dead partition's byte budget back
        into the live partitions (its entries were already rehomed to new
        primaries) so no budget is stranded.  The partition object stays in
        place — space indices mirror store node ids — but at zero capacity
        it can never admit again."""
        self.dead.add(shard)
        dead = self.spaces[shard]
        budget = dead.main.capacity
        dead.resize(0)
        live = [i for i, sp in enumerate(self.spaces)
                if i not in self.dead and sp.main.capacity > 0]
        if budget <= 0 or not live:
            return
        share = budget // len(live)
        for j, i in enumerate(live):
            self.spaces[i].resize(self.spaces[i].main.capacity + share
                                  + (budget - share * len(live)
                                     if j == 0 else 0))

    def rehome(self, iids: Iterable[int]) -> int:
        """Targeted invalidation after a ring change: drop only the
        remapped items' entries and partition placement (the next access
        re-places them on their new primary's partition); every other
        entry keeps its cache state — no full flush."""
        n = 0
        for iid in iids:
            space = self._placement.pop(iid, None)
            if space is not None:
                space.invalidate(iid)
                n += 1
        return n

    # -- TwoSpaceCache surface --------------------------------------------
    def lookup(self, key, now: float = 0.0):
        return self._space(key).lookup(key, now)

    def contains(self, key) -> bool:
        return self._space(key).contains(key)

    def put_demand(self, key, value, size: int) -> None:
        self._space(key).put_demand(key, value, size)

    def put_prefetch(self, key, value, size: int, available_at: float,
                     cause=None) -> bool:
        return self._space(key).put_prefetch(key, value, size, available_at,
                                             cause=cause)

    def write(self, key, value, size: int) -> None:
        self._space(key).write(key, value, size)

    def invalidate(self, key) -> None:
        self._space(key).invalidate(key)

    # -- stats -------------------------------------------------------------
    @property
    def stats(self) -> CacheStats:
        return sum_stats(s.stats for s in self.spaces)

    @stats.setter
    def stats(self, value: CacheStats) -> None:
        # aggregated counters cannot be re-distributed over partitions, so
        # only the reset idiom `cache.stats = CacheStats()` is supported
        if any(getattr(value, f.name) for f in dataclasses.fields(CacheStats)):
            raise ValueError(
                "a sharded cache's stats can only be reset with a fresh "
                "CacheStats, not overwritten with accumulated counters")
        for s in self.spaces:
            s.stats = CacheStats()

    def per_shard_stats(self) -> list[CacheStats]:
        return [s.stats for s in self.spaces]

    @property
    def attr(self) -> AttributionTable:
        """Per-pattern prefetch attribution merged over partitions."""
        return AttributionTable.merged(s.attr for s in self.spaces)

    def reset_attr(self) -> None:
        for s in self.spaces:
            s.reset_attr()


# ---------------------------------------------------------------------------
# Pattern exchange (gossiped metastore)
# ---------------------------------------------------------------------------


class PatternExchange:
    """Cluster-wide pattern metastore, held in container-*key* space.

    Each client's item ids are private to its own vocabulary, so patterns
    are decoded to container keys on publish and re-encoded into the
    subscriber's vocabulary on pull (growing it as needed).  Merging keeps
    the highest support seen for a sequence anywhere in the cluster.  Both
    pattern families are gossiped: row-level (main metastore) and the
    generalized ``(table, *, column)`` patterns of hybrid column mining
    (paper §3.1 type 1) — the latter matter most on workloads like TPC-C
    where concrete rows rarely repeat across tenants.
    """

    def __init__(self, capacity: int = 10_000, max_pattern_len: int = 15):
        self.store = PatternMetastore(capacity, max_pattern_len)
        self.col_store = PatternMetastore(capacity, max_pattern_len)
        self.publishes = 0
        self.pulls = 0

    def publish(self, client: PalpatineClient) -> int:
        pats = [Pattern(client.logger.db.decode(p.items), p.support)
                for p in client.metastore]
        if pats:
            self.store.merge(pats)
        col_pats = []
        if client.col_metastore is not None:
            col_pats = [Pattern(client.col_logger.db.decode(p.items), p.support)
                        for p in client.col_metastore]
            if col_pats:
                self.col_store.merge(col_pats)
        if pats or col_pats:
            self.publishes += 1
        return len(pats) + len(col_pats)

    def pull(self, client: PalpatineClient) -> int:
        """Merge the cluster's patterns into ``client`` and rebuild its
        probabilistic trees — a cold client warms up from its peers.

        ``replace_index`` is engine-agnostic: on a vectorized client
        (``PalpatineConfig.use_vectorized``) it also flattens the new
        forest into the CSR arrays the batched decision walk consumes,
        so the pull carries the one-time flatten cost of a mining
        generation, not the per-op path."""
        n = 0
        if len(self.store):
            local = [Pattern(client.logger.db.encode(p.items), p.support)
                     for p in self.store]
            client.metastore.merge(local)
            client.engine.replace_index(PTreeIndex.build(client.metastore))
            n += len(local)
        if len(self.col_store) and client.cfg.column_mining:
            if client.col_metastore is None:
                client.col_metastore = PatternMetastore(
                    self.col_store.capacity, self.col_store.max_pattern_len)
            local = [Pattern(client.col_logger.db.encode(p.items), p.support)
                     for p in self.col_store]
            client.col_metastore.merge(local)
            client.col_engine.replace_index(
                PTreeIndex.build(client.col_metastore))
            n += len(local)
        if n:
            self.pulls += 1
        return n

    def __len__(self) -> int:
        return len(self.store) + len(self.col_store)


class VerdictExchange:
    """Failure-verdict gossip between coordinator front-ends — the
    PatternExchange idiom applied to suspicion state.

    Each round, every coordinator publishes its detector's exported
    verdicts (Lamport-flip-stamped) into its own :class:`~repro.core.
    metastore.VerdictBoard`, pairwise-merges boards with every peer it can
    reach — gossip between coordinators crosses the same chaos partitions
    data RPCs do — and adopts the merged board's fresher verdicts into its
    local detector.  Because board merge order is immaterial (freshness is
    the total ``(stamp, coord)`` order), coordinators that disagree inside
    a partition converge to identical suspicion pictures once it heals.
    """

    def __init__(self) -> None:
        self.rounds = 0
        self.blocked = 0    # pairwise merges refused by an active partition
        self.adopted = 0    # verdicts that flipped a local detector

    def gossip(self, stores: Sequence[ShardedDKVStore],
               now: float) -> int:
        """One gossip round over ``stores``; returns verdicts adopted."""
        coords = [s for s in stores if s.detector is not None]
        for s in coords:
            s.verdict_board.publish(s.coord_id,
                                    s.detector.export_verdicts())
        for i, a in enumerate(coords):
            for b in coords[i + 1:]:
                chaos = a.chaos
                if chaos is not None and (
                        chaos.partitioned(now, a.coord_name, b.coord_name)
                        or chaos.partitioned(now, b.coord_name,
                                             a.coord_name)):
                    self.blocked += 1
                    continue
                a.verdict_board.merge(b.verdict_board)
                b.verdict_board.merge(a.verdict_board)
        adopted = 0
        for s in coords:
            for node, (stamp, _coord, suspected, phi) in \
                    s.verdict_board.snapshot():
                adopted += int(s.detector.adopt_verdict(
                    node, stamp, suspected, phi))
        self.adopted += adopted
        self.rounds += 1
        return adopted


# ---------------------------------------------------------------------------
# Interleaved multi-client drivers
# ---------------------------------------------------------------------------


def _apply_op(client, op):
    """One workload op: a bare key (read), ('r', key), ('w', key[, value]),
    or ('mr', [keys]) — a batched read issued as overlapping in-flight
    demand fetches.  Returns (kind, latency, value)."""
    if isinstance(op, tuple) and len(op) >= 2 and op[0] in ("r", "w", "mr"):
        if op[0] == "w":
            value = op[2] if len(op) > 2 else b"x" * 64
            return "w", client.write(op[1], value), None
        if op[0] == "mr":
            values, lat = client.read_many(op[1])
            return "r", lat, values
        value, lat = client.read(op[1])
        return "r", lat, value
    value, lat = client.read(op)
    return "r", lat, value


def _interleave(tenants: Sequence, streams: Sequence[Iterable],
                think_time: float,
                on_op: Optional[Callable[[], None]] = None,
                collect_values: bool = False):
    """Run each tenant's session stream, always stepping the tenant whose
    virtual clock is furthest behind — M concurrent clients sharing the
    store's per-node channels, without wall-clock threads."""
    n = len(tenants)
    sess_iters = [iter(s) for s in streams]
    ops: list[list] = [[] for _ in range(n)]
    pos = [0] * n
    lats: list[list[float]] = [[] for _ in range(n)]
    vals: Optional[list[list]] = [[] for _ in range(n)] if collect_values else None

    def refill(i: int) -> bool:
        while pos[i] >= len(ops[i]):
            nxt = next(sess_iters[i], None)
            if nxt is None:
                return False
            ops[i] = list(nxt)
            pos[i] = 0
        return True

    heap = []
    for i, t in enumerate(tenants):
        if refill(i):
            heapq.heappush(heap, (t.clock.now, i))
    while heap:
        _, i = heapq.heappop(heap)
        t = tenants[i]
        op = ops[i][pos[i]]
        pos[i] += 1
        kind, lat, value = _apply_op(t, op)
        if kind == "r":
            lats[i].append(lat)
            if vals is not None:
                vals[i].append(value)
        if on_op is not None:
            on_op()
        if pos[i] >= len(ops[i]):
            if hasattr(t, "end_session"):
                t.end_session()
            t.clock.advance(think_time)
        if refill(i):
            heapq.heappush(heap, (t.clock.now, i))
    return lats, vals


@dataclasses.dataclass
class ClusterConfig:
    n_clients: int = 4
    palpatine: PalpatineConfig = dataclasses.field(default_factory=PalpatineConfig)
    shard_caches: bool = True            # per-shard two-space caches
    exchange_every_ops: Optional[int] = 2_000   # gossip period (cluster ops)
    exchange_capacity: int = 10_000
    think_time: float = 1e-3             # virtual gap between sessions
    # eviction coordination: re-split each tenant's cache budget across
    # shards by observed traffic skew every N cluster ops (None = never)
    rebalance_every_ops: Optional[int] = None


class ClusterClient:
    """M concurrent ``PalpatineClient`` tenants against a sharded store.

    Every tenant has its own virtual clock, monitor, miner, and cache (so
    tenants are isolated); they share the store's per-node channels and the
    gossiped pattern metastore.  Each tenant mines on ``device`` (default
    the card): it is built there, because its ``__init__`` registers it
    with the store (``store.watch``).
    """

    def __init__(self, store: ShardedDKVStore,
                 cfg: Optional[ClusterConfig] = None, device=None):
        self.store = store
        self.cfg = cfg or ClusterConfig()
        pcfg = self.cfg.palpatine
        self.exchange = PatternExchange(self.cfg.exchange_capacity,
                                        pcfg.mining.max_len)
        factory = None
        if self.cfg.shard_caches:
            def factory(client: PalpatineClient) -> ShardedTwoSpaceCache:
                cache = ShardedTwoSpaceCache(
                    store.n_shards, pcfg.cache_bytes, pcfg.preemptive_frac,
                    key_of=client.logger.db.item, shard_of=store.shard_of)
                # a client joining after node removals must not strand
                # budget on partitions no key can map to: retire them
                # up front (their shares fold into the live partitions)
                for s in sorted(getattr(store, "removed", ())):
                    cache.drop_shard(s)
                return cache
        self.tenants = [PalpatineClient(store, pcfg, cache_factory=factory,
                                        device=device)
                        for _ in range(self.cfg.n_clients)]
        self.rebalancers = ([BudgetRebalancer() for _ in self.tenants]
                            if self.cfg.shard_caches else [])
        if hasattr(store, "watch_membership"):
            store.watch_membership(self._on_membership)
        self.total_ops = 0

    # -- membership --------------------------------------------------------
    def _on_membership(self, event: MembershipEvent) -> None:
        """Ring change landed: grow every tenant's per-shard cache for a
        joining node, then fire targeted invalidations for exactly the
        remapped keys (no full flush — unmoved entries keep serving)."""
        for t in self.tenants:
            if event.kind == "add" and hasattr(t.cache, "add_shard"):
                t.cache.add_shard()
            t.on_keys_remapped(event.remapped_keys)
            if event.kind == "remove" and hasattr(t.cache, "drop_shard"):
                # after the rehome: the dead partition is empty, fold its
                # budget back into the live ones
                t.cache.drop_shard(event.node)

    def rebalance_budgets(self) -> int:
        """One eviction-coordination round: re-split each tenant's cache
        budget across shards by its observed per-shard traffic skew.
        Partitions of *suspected* nodes are frozen in place — a transient
        failure verdict must not bleed budget that would thrash back on
        recovery (only removal folds a partition's budget away for good).
        Returns the number of tenants whose partitions were resized."""
        detector = getattr(self.store, "detector", None)
        suspended = detector.suspects() if detector is not None else ()
        return sum(int(r.rebalance(t.cache, suspended=suspended))
                   for r, t in zip(self.rebalancers, self.tenants))

    # -- driving -----------------------------------------------------------
    def run(self, streams: Sequence[Iterable], collect_values: bool = False):
        """``streams[i]`` is tenant i's iterable of sessions (lists of ops).
        Returns per-tenant read latencies; with ``collect_values`` also the
        per-tenant observed values."""
        if len(streams) != len(self.tenants):
            raise ValueError("one session stream per tenant")

        def on_op() -> None:
            self.total_ops += 1
            every = self.cfg.exchange_every_ops
            if every and self.total_ops % every == 0:
                self.exchange_patterns()
            revery = self.cfg.rebalance_every_ops
            if revery and self.total_ops % revery == 0:
                self.rebalance_budgets()

        lats, vals = _interleave(self.tenants, streams, self.cfg.think_time,
                                 on_op, collect_values)
        return (lats, vals) if collect_values else lats

    # -- mining + gossip ---------------------------------------------------
    def mine_all(self, skip_unchanged: bool = True) -> int:
        """Re-mine every tenant.  Mining is deterministic, so a tenant whose
        monitored backlog has not grown since its last run would reproduce
        byte-identical patterns — the gossip-triggered sweep skips its
        lattice walk and keeps the existing metastore.  Pass
        ``skip_unchanged=False`` to force the full walk everywhere."""
        total = 0
        for t in self.tenants:
            if skip_unchanged and t.backlog_unchanged_since_mine():
                total += len(t.metastore)
            else:
                total += t.mine_now()
        return total

    def exchange_patterns(self) -> None:
        """One gossip round: everyone publishes, then everyone pulls."""
        for t in self.tenants:
            self.exchange.publish(t)
        for t in self.tenants:
            self.exchange.pull(t)

    # -- observability -----------------------------------------------------
    def enable_tracing(self, tracer) -> None:
        """Install a tracer cluster-wide: the store's coordinators and
        nodes plus every tenant's client-side hooks share one span stack,
        so a trace follows an op from the tenant's cache lookup down to
        the replica's service interval."""
        if hasattr(self.store, "enable_tracing"):
            self.store.enable_tracing(tracer)
        else:
            self.store.tracer = tracer
        for t in self.tenants:
            t.tracer = tracer

    def aggregate_attribution(self) -> AttributionTable:
        """Per-pattern prefetch attribution merged over tenants."""
        return AttributionTable.merged(t.cache.attr for t in self.tenants)

    # -- telemetry ---------------------------------------------------------
    def reset_stats(self) -> None:
        for t in self.tenants:
            t.cache.stats = CacheStats()
            if hasattr(t.cache, "reset_attr"):
                t.cache.reset_attr()

    def aggregate_stats(self) -> CacheStats:
        return sum_stats(t.cache.stats for t in self.tenants)

    def per_shard_stats(self) -> list[CacheStats]:
        """Per-storage-node cache stats summed over tenants (needs
        ``shard_caches``)."""
        out = []
        for shard in range(self.store.n_shards):
            out.append(sum_stats(
                t.cache.per_shard_stats()[shard] for t in self.tenants))
        return out


class ClusterBaseline:
    """M unmodified clients interleaved the same way — the scaling baseline."""

    def __init__(self, store: ShardedDKVStore, n_clients: int,
                 think_time: float = 1e-3):
        self.store = store
        self.tenants = [BaselineClient(store) for _ in range(n_clients)]
        self.think_time = think_time

    def run(self, streams: Sequence[Iterable], collect_values: bool = False):
        if len(streams) != len(self.tenants):
            raise ValueError("one session stream per tenant")
        lats, vals = _interleave(self.tenants, streams, self.think_time,
                                 collect_values=collect_values)
        return (lats, vals) if collect_values else lats
