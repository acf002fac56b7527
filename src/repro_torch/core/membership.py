"""Elastic membership & anti-entropy for the sharded DKV cluster.

Copied unchanged from ``src/repro/core/membership.py``: the port keeps
its own copy and imports nothing from ``repro``.

Palpatine's evaluation assumes a fixed cluster, but its target back stores
(Cassandra/HBase-class DKVs) live on rings that grow, shrink, and recover.
Every topology change is a cache-invalidation and replica-divergence storm
the prefetcher must survive; this module is the scale-and-recovery layer:

* **Ring scaling** — :func:`add_node` / :func:`remove_node` recompute the
  consistent-hash ring and stream *only the owed key ranges* to the new
  successor sets.  Movement is virtual-clock-costed through the existing
  :class:`~repro.core.backstore.Channel` RPC layer (source background
  channel for the range read, destination write channel for the bulk
  apply), and ordering is copy-then-prune: a key is deleted from a node
  that no longer serves it only after every new holder's copy has landed,
  so demand reads keep succeeding at every instant of the move.  Clients
  hear a :class:`MembershipEvent` naming exactly the keys whose primary
  changed — a *targeted* cache invalidation instead of a full flush.

* **Hinted handoff** — :class:`HintedHandoffLog` buffers writes owed to a
  down replica (latest version per key); ``set_down(shard, False)`` drains
  them on the recovered node's write channel, so a rejoining node converges
  without waiting for reads to touch every stale key.

* **Read-repair** — the store's read paths compare per-key monotone write
  versions across live replicas (the ``put`` frontier); a replica that
  rejoined before its hints landed (or whose hints were lost) is
  overwritten from a fresh peer the first time the key is read.  Hinted
  handoff + read-repair together converge a recovered node to
  byte-identical state.

* **Eviction coordination** — :class:`BudgetRebalancer` periodically
  reallocates a tenant's per-shard cache budget proportional to observed
  per-shard traffic/hit-mass skew, with an EMA + hysteresis band so noisy
  windows don't thrash partition sizes.  Suspected nodes' partitions are
  *frozen* (not re-split) so a transient failure verdict cannot thrash
  budgets the way a removal legitimately does.

* **Failure detection** — :class:`FailureDetector` accrues per-node
  suspicion (a phi score, Hayashibara-style) from the missed acks and
  per-node service times the :class:`~repro.core.backstore.Channel` /
  ``RPCFuture`` layer observes.  Timeouts add large increments; acks decay
  the score; an ack merely *late* against the node's own service EWMA adds
  a small increment — so a crashed node is suspected within a bounded
  number of ops while a slow-but-alive node rides inside the hysteresis
  band (``clear_phi`` < phi < ``suspect_phi``) without ever flapping.
  ``ShardedDKVStore.set_down`` remains as the test override; routing,
  quorum accounting and the rebalancer consume the detector's verdicts.

* **Range-transfer leases** — :class:`LeaseTable` admits *overlapping*
  ``add_node`` / ``remove_node`` calls concurrently: each change leases
  exactly the key set it moves, conflicting changes (shared keys or the
  same node) raise :class:`LeaseConflict`, and nested changes defer their
  ring cutover and pruning to the outermost change's completion so reads
  are served from the installed ring at every instant of every move.

MITHRIL (Yang et al., PAPERS.md) shows prefetch-layer benefit evaporates
when cache budgets are misallocated across skewed partitions, and the
microsecond-latency KV-store study (Mita et al.) shows tail latency is
dominated by degraded/recovering-node windows — exactly the two regimes
this subsystem closes.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Iterable, Optional, Sequence

from .obs import NULL_TRACER, SPAN_MEMBERSHIP

__all__ = [
    "MoveReport",
    "MembershipEvent",
    "HintedHandoffLog",
    "FailureDetector",
    "LeaseConflict",
    "RangeLease",
    "LeaseTable",
    "BudgetRebalancer",
    "build_ring",
    "add_node",
    "remove_node",
    "drain_node",
]

#: keys per streamed range batch (one background-channel read + one bulk
#: write-channel apply per batch)
STREAM_BATCH = 64


def _hash64(x) -> int:
    """Stable 64-bit hash of a container key (process-independent, unlike
    builtin ``hash`` which is salted per process)."""
    return int.from_bytes(
        hashlib.blake2b(repr(x).encode(), digest_size=8).digest(), "big")


def build_ring(node_ids: Iterable[int], vnodes: int) -> tuple[list, list]:
    """The consistent-hash ring for a node set: sorted virtual-node points
    plus their owners.  Vnode identities depend only on the node id, so a
    ring grown one node at a time is identical to one built at full size —
    which is what bounds movement to the joining node's owed ranges."""
    ring = []
    for s in node_ids:
        for v in range(vnodes):
            ring.append((_hash64(f"shard{s}:vnode{v}"), s))
    ring.sort()
    return [p for p, _ in ring], [s for _, s in ring]


@dataclasses.dataclass
class MoveReport:
    """Streamed-range accounting for one membership change."""

    kind: str                  # "add" | "remove"
    node: int
    resident_keys: int         # unique keys resident before the change
    keys_streamed: int         # unique keys copied to >= 1 new holder
    placements_gained: int     # (key, node) copies created
    placements_dropped: int    # (key, node) copies pruned after the move
    bytes_streamed: int
    lost_keys: int             # keys with no live source to stream from
    hinted_placements: int     # owed copies deferred to hinted handoff
                               # (destination was down during the move)
    replication: int
    started_at: float
    done_at: float             # when the last range batch landed
    #: stale reads the coordinator counted while this change streamed —
    #: a *planned* drain (``drain_node``) asserts this stays 0: the node
    #: is live the whole time, so the full old replica set keeps serving
    stale_reads_during: int = 0

    @property
    def moved_fraction(self) -> float:
        """Fraction of resident keys that had to move — the elasticity
        headline: ~1/(N+1) for a node joining an N-node ring at R=1."""
        return (self.keys_streamed / self.resident_keys
                if self.resident_keys else 0.0)

    @property
    def placement_fraction(self) -> float:
        """Fraction of (key, replica) placements that moved — the
        replication-independent ring-math invariant (~1/(N+1) for a
        joiner, regardless of R)."""
        total = self.replication * self.resident_keys
        return self.placements_gained / total if total else 0.0


@dataclasses.dataclass(frozen=True)
class MembershipEvent:
    """Broadcast to cluster clients after a ring change lands.

    ``remapped_keys`` are exactly the keys whose *primary* moved — the set
    a per-shard client cache must re-place (targeted invalidation; keys
    with unchanged primaries keep their cache entries untouched)."""

    kind: str
    node: int
    remapped_keys: tuple
    report: MoveReport


# ---------------------------------------------------------------------------
# Hinted handoff
# ---------------------------------------------------------------------------


class HintedHandoffLog:
    """Write buffer for down replicas (Dynamo-style hinted handoff).

    A write whose preference list includes a down node leaves a *hint*
    (key, value, version) addressed to it; only the latest version per key
    is kept.  Draining replays the hints on the recovered node's write
    channel, skipping keys the node already holds at an equal-or-newer
    version (a concurrent read-repair may have won the race).

    A hint may also name a *holder*: the ring successor that physically
    accepted the write in the intended owner's stead (sloppy quorum).  The
    holder's copy serves availability while the owner is out; the drain
    hands the write back and the store prunes the holder's stray copy —
    per-key hint ownership, Dynamo §4.6.

    Every enqueued hint is conserved: it ends exactly one of *replayed*
    (landed on its owner), *superseded* (a newer version made it moot),
    *replaced* (a newer hint for the same key took its slot), *discarded*
    (its owner left the ring for good), or still pending.  The chaos
    invariant checker asserts that identity after every fault schedule —
    ``enqueued == replayed + superseded + replaced + discarded + len()``
    once the world heals — so a sloppy write can never silently vanish.
    """

    def __init__(self) -> None:
        # node -> {key: (value, version, holder-or-None)}
        self._hints: dict[int, dict] = {}
        self.enqueued = 0
        self.replayed = 0
        self.superseded = 0   # dead on arrival / obsolete by the time of drain
        self.replaced = 0     # a newer hint for the same (node, key) won
        self.discarded = 0    # addressee decommissioned, never drains

    def add(self, node: int, key, value: bytes, version: int,
            holder: Optional[int] = None) -> None:
        slot = self._hints.setdefault(node, {})
        old = slot.get(key)
        if old is None:
            slot[key] = (value, version, holder)
        elif version > old[1]:
            slot[key] = (value, version, holder)
            self.replaced += 1
        else:
            self.superseded += 1   # incoming hint is already obsolete
        self.enqueued += 1

    def get_hint(self, node: int, key) -> Optional[tuple]:
        """The pending (value, version, holder) for ``key``, if any."""
        return self._hints.get(node, {}).get(key)

    def pending(self, node: int) -> int:
        return len(self._hints.get(node, ()))

    def take(self, node: int) -> dict:
        """Pop and return every hint addressed to ``node``.  The caller
        owns the accounting from here: each taken hint must end up
        replayed, superseded, or handed back via :meth:`restore`."""
        return self._hints.pop(node, {})

    def restore(self, node: int, key, hint: tuple) -> None:
        """Re-enqueue a taken hint whose replay could not be delivered
        (chaos dropped the message, or the hand-back holder was itself
        unreachable mid-drain).  No double count on ``enqueued`` — the
        hint is still the same obligation; if a newer hint arrived for
        the slot while the drain was in flight, the older of the two is
        accounted superseded."""
        slot = self._hints.setdefault(node, {})
        old = slot.get(key)
        if old is None:
            slot[key] = hint
        elif hint[1] > old[1]:
            slot[key] = hint
            self.superseded += 1
        else:
            self.superseded += 1

    def discard(self, node: int) -> int:
        """Drop every hint addressed to ``node`` (decommission: the
        addressee never rejoins, so the hints can never drain)."""
        dropped = self._hints.pop(node, {})
        self.discarded += len(dropped)
        return len(dropped)

    def conserved(self) -> bool:
        """The conservation identity (see class docstring)."""
        return self.enqueued == (self.replayed + self.superseded
                                 + self.replaced + self.discarded
                                 + len(self))

    def __len__(self) -> int:
        return sum(len(v) for v in self._hints.values())


# ---------------------------------------------------------------------------
# Emergent failure detection: phi-accrual suspicion with hysteresis
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _NodeHealth:
    phi: float = 0.0            # accrued suspicion
    ewma: Optional[float] = None  # this node's own service-time EWMA
    ack_streak: int = 0         # consecutive acks since the last miss
    suspected: bool = False
    probe_tick: int = 0
    #: Lamport stamp of the last verdict *flip* (suspect or clear) — the
    #: freshness order verdict gossip merges on; 0 = never flipped
    stamp: int = 0


class FailureDetector:
    """Phi-accrual-style failure detection from observed RPC outcomes.

    Every demand/write RPC the sharded front-end issues feeds one
    observation per node: an *ack* (with its virtual service time) or a
    *missed ack* (the RPC expired at the coordinator's timeout).  The
    per-node suspicion score ``phi`` accrues:

    * a missed ack adds ``timeout_phi`` — a crashed node is suspected
      after ``ceil(suspect_phi / timeout_phi)`` consecutive misses, i.e.
      within a *bounded number of ops* touching it;
    * an ack halves phi (``ack_decay``) — live nodes converge to zero;
    * an ack that is merely *late* against the node's own service EWMA
      (``service > slow_factor * ewma``) adds the small ``slow_phi``
      instead — occasional GC-pause stalls push phi into the hysteresis
      band (``clear_phi`` .. ``suspect_phi``) but never over it, so a
      slow-but-alive node is never suspected and never flaps.

    A suspected node stops receiving traffic, so suspicion can only clear
    through *probes*: the front-end pings each suspect every
    ``probe_every`` ops; ``clear_acks`` consecutive probe acks (with phi
    decayed back under ``clear_phi``) clear the verdict — the caller then
    drains the node's hinted handoffs, completing the emergent
    crash → suspect → recover → converge cycle without one ``set_down``.
    """

    def __init__(self, suspect_phi: float = 8.0, clear_phi: float = 1.0,
                 timeout_phi: float = 4.0, slow_phi: float = 1.0,
                 slow_factor: float = 6.0, ack_decay: float = 0.5,
                 clear_acks: int = 3, probe_every: int = 8):
        if not 0.0 <= clear_phi < suspect_phi:
            raise ValueError("need 0 <= clear_phi < suspect_phi")
        self.suspect_phi = float(suspect_phi)
        self.clear_phi = float(clear_phi)
        self.timeout_phi = float(timeout_phi)
        self.slow_phi = float(slow_phi)
        self.slow_factor = float(slow_factor)
        self.ack_decay = float(ack_decay)
        self.clear_acks = int(clear_acks)
        self.probe_every = max(1, int(probe_every))
        self._nodes: dict[int, _NodeHealth] = {}
        self.acks = 0
        self.timeouts = 0
        self.suspicions = 0        # down verdicts issued
        self.clears = 0            # verdicts revoked by probe acks
        #: Lamport clock over verdict flips; merged on gossip adoption so
        #: a coordinator's later flips always outrank what it adopted
        self.lamport = 0
        self.adopted = 0           # verdicts taken over from gossip

    def _node(self, node: int) -> _NodeHealth:
        h = self._nodes.get(node)
        if h is None:
            h = self._nodes[node] = _NodeHealth()
        return h

    # -- observations ------------------------------------------------------
    def observe_ack(self, node: int, service: Optional[float] = None) -> bool:
        """One acked RPC (``service`` = its virtual latency; None for a
        latency-free probe).  Returns True iff this ack *cleared* a
        standing suspicion — the caller should then drain the node's
        hinted handoffs (the emergent rejoin)."""
        h = self._node(node)
        self.acks += 1
        late = (service is not None and h.ewma is not None
                and service > self.slow_factor * h.ewma)
        if service is not None:
            h.ewma = (service if h.ewma is None
                      else 0.8 * h.ewma + 0.2 * service)
        if late:
            h.phi = min(self.suspect_phi - self.clear_phi,
                        h.phi + self.slow_phi)   # band-capped: never a verdict
            h.ack_streak = 0
            return False
        h.phi *= self.ack_decay
        h.ack_streak += 1
        if (h.suspected and h.ack_streak >= self.clear_acks
                and h.phi <= self.clear_phi):
            h.suspected = False
            h.phi = 0.0
            self.lamport += 1
            h.stamp = self.lamport
            self.clears += 1
            return True
        return False

    def observe_timeout(self, node: int) -> bool:
        """One missed ack.  Returns True iff this miss crossed the
        suspicion threshold (a fresh down verdict)."""
        h = self._node(node)
        self.timeouts += 1
        # cap the accrual: a long-dead node must still clear in a bounded
        # number of probe acks once it comes back
        h.phi = min(h.phi + self.timeout_phi, 2.0 * self.suspect_phi)
        h.ack_streak = 0
        if not h.suspected and h.phi >= self.suspect_phi:
            h.suspected = True
            self.lamport += 1
            h.stamp = self.lamport
            self.suspicions += 1
            return True
        return False

    # -- verdict gossip (see cluster.VerdictExchange) ----------------------
    def export_verdicts(self) -> dict[int, tuple[int, bool, float]]:
        """Every node this detector has ever flipped a verdict on, as
        ``node -> (stamp, suspected, phi)``.  Nodes with no flip yet carry
        no record — a coordinator that never saw a node's traffic has
        nothing to say about it, which is exactly why gossip helps."""
        return {n: (h.stamp, h.suspected, h.phi)
                for n, h in sorted(self._nodes.items()) if h.stamp > 0}

    def adopt_verdict(self, node: int, stamp: int, suspected: bool,
                      phi: float) -> bool:
        """Take over a gossiped verdict iff it is strictly fresher than
        this detector's own last flip for the node.  Adoption is a real
        flip (counted, stamped) when it changes the verdict; either way
        the local Lamport clock absorbs the remote stamp, so a *later*
        local observation (e.g. a probe ack from a recovered node) always
        outranks what was adopted and can propagate back."""
        h = self._node(node)
        if stamp <= h.stamp:
            return False
        self.lamport = max(self.lamport, stamp)
        h.stamp = stamp
        if h.suspected == suspected:
            return False
        h.suspected = suspected
        h.ack_streak = 0
        if suspected:
            # trust the remote accrual but keep the clear path honest: the
            # node must still earn clear_acks probe acks to shed the verdict
            h.phi = max(float(phi), self.suspect_phi)
            self.suspicions += 1
        else:
            h.phi = 0.0
            self.clears += 1
        self.adopted += 1
        return True

    # -- verdicts ----------------------------------------------------------
    def phi(self, node: int) -> float:
        h = self._nodes.get(node)
        return h.phi if h is not None else 0.0

    def suspected(self, node: int) -> bool:
        h = self._nodes.get(node)
        return h.suspected if h is not None else False

    def suspects(self) -> set[int]:
        return {n for n, h in self._nodes.items() if h.suspected}

    def should_probe(self, node: int) -> bool:
        """Rate-limit recovery probes: True every ``probe_every``-th call
        per suspect (deterministic, op-driven)."""
        h = self._node(node)
        h.probe_tick += 1
        return h.probe_tick % self.probe_every == 0

    def reset(self, node: int) -> None:
        """Forget a node's state (test override / decommission)."""
        self._nodes.pop(node, None)


# ---------------------------------------------------------------------------
# Range-transfer leases: concurrent membership changes
# ---------------------------------------------------------------------------


class LeaseConflict(ValueError):
    """A membership change's owed ranges overlap an in-flight transfer."""


@dataclasses.dataclass(frozen=True)
class RangeLease:
    """One membership change's claim: the node it adds/removes plus the
    exact key set whose placement it moves (streams or prunes)."""

    change_id: int
    kind: str
    node: int
    keys: frozenset

    def conflicts(self, other: "RangeLease") -> bool:
        return self.node == other.node or bool(self.keys & other.keys)


class LeaseTable:
    """Active range-transfer leases.  Overlapping ``add_node`` /
    ``remove_node`` calls are admitted concurrently iff their leases are
    disjoint; a conflicting change raises :class:`LeaseConflict` *before*
    it mutates anything, leaving the in-flight transfer untouched."""

    def __init__(self) -> None:
        self._active: dict[int, RangeLease] = {}
        self._next_id = 0
        self.granted = 0
        self.rejected = 0

    def acquire(self, kind: str, node: int, keys: Iterable) -> RangeLease:
        lease = RangeLease(self._next_id, kind, node, frozenset(keys))
        for held in self._active.values():
            if lease.conflicts(held):
                self.rejected += 1
                raise LeaseConflict(
                    f"{kind} node {node} overlaps in-flight {held.kind} of "
                    f"node {held.node} (lease {held.change_id}: "
                    f"{len(lease.keys & held.keys)} shared keys)")
        self._next_id += 1
        self._active[lease.change_id] = lease
        self.granted += 1
        return lease

    def release(self, lease: RangeLease) -> None:
        self._active.pop(lease.change_id, None)

    def __len__(self) -> int:
        return len(self._active)


# ---------------------------------------------------------------------------
# Ring scaling: add / remove node with owed-range streaming
# ---------------------------------------------------------------------------


def _rebuild_ring(store) -> None:
    ids = [i for i in range(len(store.shards)) if i not in store.removed]
    if not ids:
        raise ValueError("cannot remove the last ring node")
    store._points, store._owners = build_ring(ids, store.vnodes)
    store._replica_cache = {}   # fresh dict: stale rings may keep theirs


def _stream_ranges(store, moves: dict, now: float,
                   on_batch: Optional[Callable[[float], None]] = None
                   ) -> tuple[int, float]:
    """Copy the owed ranges, one (source, destination) pair at a time.

    Each batch is one range read on the source's *background* channel (bulk
    moves never contend with demand reads) followed by one bulk apply on
    the destination's write channel, entering service when the read lands.
    Returns ``(bytes_streamed, done_at)``.  ``on_batch(landed_at)`` fires
    after each batch's copy is applied — mid-move, with the ring already
    recomputed and pruning still pending — which is where the elasticity
    tests probe that reads keep being served."""
    total_bytes = 0
    done_at = now
    for (src, dst) in sorted(moves):
        keys = moves[(src, dst)]
        src_node, dst_node = store.shards[src], store.shards[dst]
        for i in range(0, len(keys), STREAM_BATCH):
            batch = keys[i:i + STREAM_BATCH]
            vals, read_done = src_node.background_get(batch, now)
            items = [(k, v, src_node.versions.get(k, 0))
                     for k, v in zip(batch, vals) if v is not None]
            # one bulk apply on the destination's write channel, through
            # the sanctioned chokepoint (membership transfers are
            # operator-driven and chaos-exempt: src stays None)
            landed = dst_node.bulk_apply(items, read_done)
            total_bytes += sum(len(v) for _, v, _ in items)
            done_at = max(done_at, landed)
            if on_batch is not None:
                on_batch(landed)
    return total_bytes, done_at


def _relocate(store, kind: str, node: int, now: float,
              on_batch: Optional[Callable[[float], None]] = None
              ) -> MoveReport:
    """Recompute the ring and stream only the owed ranges.

    Ordering is copy-then-cutover-then-prune: the *installed* routing
    table stays live while the owed ranges stream (old owners hold every
    key, so reads keep being served mid-move); the new ring goes live only
    once the last batch lands, and only then are stale copies pruned.

    Changes may overlap: a second ``add_node``/``remove_node`` issued from
    a streaming batch's ``on_batch`` is admitted concurrently when its
    range-transfer lease (the exact key set it moves) is disjoint from
    every in-flight change's — otherwise it raises :class:`LeaseConflict`
    without side effects.  A nested change diffs against the *pending
    frontier* (the newest in-flight ring, so already-claimed ranges are
    not re-streamed) and defers its cutover + prune to the outermost
    change's completion, when the final ring is installed once."""
    # the leaving node's data still counts as resident (it is the source of
    # its owed ranges while live); already-removed nodes never do
    skip = store.removed - ({node} if kind == "remove" else set())
    resident: set = set()
    for i, s in enumerate(store.shards):
        if i not in skip:
            resident.update(s.data.keys())
    ordered = sorted(resident, key=repr)   # deterministic stream order

    # diff old -> new placement: "old" is the pending frontier (the newest
    # in-flight ring when nested, else the installed ring); "new" reflects
    # every admitted change including this one
    installed = (store._points, store._owners, store._replica_cache)
    frontier = store._pending_rings[-1] if store._pending_rings else installed
    old_reps = {k: store._ring_replicas(k, *frontier) for k in ordered}
    _rebuild_ring(store)
    new_ring = (store._points, store._owners, store._replica_cache)
    store._points, store._owners, store._replica_cache = installed

    moves: dict[tuple[int, int], list] = {}
    prune: dict[int, list] = {}
    remapped: list = []
    streamed: set = set()
    affected: set = set()              # every key this change re-places
    hinted: list = []                  # (destination, key, source) deferred
    gained_n = lost_keys = 0
    for k in ordered:
        old = old_reps[k]
        new = store._ring_replicas(k, *new_ring)
        if new[0] != old[0]:
            remapped.append(k)
        gained = [d for d in new if d not in old]
        if gained:
            affected.add(k)
            sources = [s for s in old
                       if s not in skip and not store._failed(s)]
            if not sources:
                lost_keys += 1
            else:
                src = sources[0]   # primary-preferred (preference order)
                for d in gained:
                    if store._failed(d):
                        # a crashed/suspected node cannot receive a range
                        # transfer: defer its owed copy to hinted handoff,
                        # the same anti-entropy path ordinary writes use
                        # (it lands on its write channel at drain time)
                        hinted.append((d, k, src))
                    else:
                        moves.setdefault((src, d), []).append(k)
                        gained_n += 1
                        streamed.add(k)
        for d in old:
            if d not in new:
                affected.add(k)
                prune.setdefault(d, []).append(k)

    # admission control BEFORE any mutation: a conflicting overlap must
    # leave the store (hints included) untouched
    lease = store.leases.acquire(kind, node, affected)
    store._held_leases.append(lease)
    for d, k, src in hinted:
        store.hints.add(d, k, store.shards[src].data[k],
                        store.shards[src].versions.get(k, 0))
    store._pending_rings.append(new_ring)  # mid-move writes reach new owners
    store._membership_depth += 1
    tr = getattr(store, "tracer", NULL_TRACER)
    sp = tr.start(SPAN_MEMBERSHIP, now)
    if sp.live:
        sp.set(kind=kind, node=node, affected=len(affected),
               streamed=len(streamed), hinted=len(hinted))
    try:
        bytes_streamed, done_at = _stream_ranges(store, moves, now, on_batch)
        sp.finish(done_at)
    except BaseException:
        sp.mark("error")
        # an exception escaping the stream (e.g. an uncaught LeaseConflict
        # from a nested change's on_batch) aborts THIS change: release its
        # lease and retract its pending ring, or both leak forever and
        # every later write/membership change breaks.  Partially streamed
        # copies are benign (non-owners under the installed ring, version-
        # stamped) and the caller rolls back the membership mutation.
        store._membership_depth -= 1
        try:
            store._pending_rings.remove(new_ring)
        except ValueError:
            pass
        try:
            store._held_leases.remove(lease)
        except ValueError:
            pass
        store.leases.release(lease)
        raise
    finally:
        tr.end(sp)
    store._membership_depth -= 1

    report = MoveReport(kind, node, len(resident), len(streamed), gained_n,
                        0, bytes_streamed, lost_keys, len(hinted),
                        store.replication, now, done_at)
    store._deferred_changes.append((kind, node, prune, remapped, report))
    if store._membership_depth == 0:
        _cutover(store)
    return report


def _finalize_aborted(store) -> None:
    """A change aborted mid-stream (its caller just rolled back the
    membership mutation).  Concurrently admitted changes that already
    finished streaming must still cut over — run it now if this was the
    outermost frame; a still-streaming outer change cuts over normally."""
    if store._membership_depth == 0 and store._deferred_changes:
        _cutover(store)


def _cutover(store) -> None:
    """Install the final ring (reflecting every admitted change at once),
    prune stale copies, sweep mid-move writes, release the range leases,
    and fire one :class:`MembershipEvent` per change."""
    _rebuild_ring(store)
    # attached coordinator front-ends (ShardedDKVStore.attach_coordinator)
    # share the storage nodes but hold their own ring bindings: propagate
    # the installed ring so every coordinator routes on the same topology
    for peer in getattr(store, "_coordinators", ()):
        if peer is not store:
            peer._points = store._points
            peer._owners = store._owners
            peer._replica_cache = store._replica_cache
            peer.n_shards = store.n_shards
    store._pending_rings.clear()
    for lease in store._held_leases:
        store.leases.release(lease)
    store._held_leases = []
    deferred = store._deferred_changes
    store._deferred_changes = []

    for kind, node, prune, remapped, report in deferred:
        dropped = 0
        for d, keys in prune.items():
            shard = store.shards[d]
            for k in keys:
                if d in store.replicas_of(k):
                    continue   # a concurrent change re-granted this copy
                if shard.data.pop(k, None) is not None:
                    dropped += 1
                shard.versions.pop(k, None)
        report.placements_dropped = dropped

    # keys first written mid-move were dual-written to installed- and
    # pending-ring owners; they are absent from the resident snapshots
    # above, so sweep their non-owner copies explicitly or they leak
    # forever — and they must join a remapped set, or a tenant cache keeps
    # their placement pinned to the old-ring (possibly dead) partition
    late_writes = sorted(store._pending_writes, key=repr)
    store._pending_writes = set()
    last = deferred[-1]
    seen_remapped = {k for _, _, _, remapped, _ in deferred for k in remapped}
    for k in late_writes:
        owners = set(store.replicas_of(k))
        for i, shard in enumerate(store.shards):
            if i not in owners and shard.data.pop(k, None) is not None:
                shard.versions.pop(k, None)
                last[4].placements_dropped += 1
        if k not in seen_remapped:
            last[3].append(k)

    for kind, node, _, remapped, report in deferred:
        event = MembershipEvent(kind, node, tuple(remapped), report)
        for cb in store._membership_watchers:
            cb(event)


def add_node(store, node_store, now: float = 0.0,
             on_batch: Optional[Callable[[float], None]] = None
             ) -> MoveReport:
    """Join ``node_store`` to ``store``'s ring.

    The new node claims its virtual nodes, the owed key ranges stream in
    from their current primaries, and stale copies are pruned only after
    the copies land.  The cluster serves reads throughout.  Raises
    :class:`LeaseConflict` (leaving the ring untouched) when the joiner's
    owed ranges overlap a concurrent in-flight change."""
    nid = len(store.shards)
    store.shards.append(node_store)
    store.n_shards = len(store.shards)
    try:
        report = _relocate(store, "add", nid, now, on_batch)
    except BaseException:
        store.shards.pop()
        store.n_shards = len(store.shards)
        _finalize_aborted(store)
        raise
    for cb in store._watchers:          # coherence monitor covers the joiner
        node_store.watch(cb)
    return report


def remove_node(store, shard: int, now: float = 0.0,
                on_batch: Optional[Callable[[float], None]] = None
                ) -> MoveReport:
    """Decommission node ``shard`` (live: it streams its own ranges out;
    down/crashed: surviving replicas stream on its behalf).  Pending hints
    addressed to it are discarded — it will never rejoin.  Raises
    :class:`LeaseConflict` (leaving the store untouched, hints included)
    when its ranges overlap a concurrent in-flight change."""
    if shard in store.removed or not 0 <= shard < len(store.shards):
        raise ValueError(f"node {shard} is not in the ring")
    if len(store.shards) - len(store.removed) <= 1:
        # validate BEFORE mutating: a rejected removal must leave the
        # store untouched (removed-set and pending hints included)
        raise ValueError("cannot remove the last ring node")
    store.removed.add(shard)
    try:
        report = _relocate(store, "remove", shard, now, on_batch)
    except BaseException:
        store.removed.discard(shard)
        _finalize_aborted(store)
        raise
    # pending hints addressed to the leaving node — pre-existing ones and
    # any a mid-move write re-enqueued (it is still in the old ring during
    # streaming) — will never be drained: discard (counted — the hint
    # conservation invariant must still balance) or they linger forever
    store.hints.discard(shard)
    store.down.discard(shard)
    if store.detector is not None:
        store.detector.reset(shard)
    return report


def drain_node(store, shard: int, now: float = 0.0,
               on_batch: Optional[Callable[[float], None]] = None
               ) -> MoveReport:
    """Planned, lease-aware decommission of a **live** node.

    ``remove_node`` tolerates a dead node (survivors stream on its
    behalf, reads ride out a degraded window); a *drain* is the
    zero-downtime variant an operator runs before maintenance: it
    refuses anything but a live, unsuspected node, pre-streams the
    node's owed ranges under the same :class:`LeaseTable` lease
    (copy-then-cutover-then-prune — the node itself keeps serving reads
    for the whole stream), and only then flips ownership.  Because the
    full old replica set stays live until cutover, **no read is served
    stale during the flip** — the report carries the coordinator's
    stale-read delta over the window so callers (and the
    ``cluster_drain_*`` benchmark section) can assert exactly that."""
    if shard in store.removed or not 0 <= shard < len(store.shards):
        raise ValueError(f"node {shard} is not in the ring")
    if store._failed(shard):
        raise ValueError(
            f"planned drain requires node {shard} live and unsuspected; "
            f"use remove_node to decommission a failed node")
    stale_before = store.stale_reads
    report = remove_node(store, shard, now, on_batch)
    report.kind = "drain"
    report.stale_reads_during = store.stale_reads - stale_before
    return report


# ---------------------------------------------------------------------------
# Eviction coordination: per-shard cache-budget rebalancing
# ---------------------------------------------------------------------------


class BudgetRebalancer:
    """Reallocate one tenant's cache budget across shard partitions by
    observed traffic skew.

    Each round reads the per-shard cache stats, takes the *delta* since the
    previous round (so old traffic ages out), EMA-smooths the per-shard
    weight — accesses plus hits, i.e. traffic mass boosted by hit mass —
    and resizes partitions toward the smoothed shares.  Two guards prevent
    thrash: a ``min_share`` floor keeps cold shards warm enough to observe
    a shift back, and the resize only applies when some partition's target
    moved by more than ``hysteresis`` of the total budget."""

    def __init__(self, min_share: float = 0.05, hysteresis: float = 0.10,
                 smoothing: float = 0.5):
        if not 0.0 <= min_share < 1.0:
            raise ValueError("min_share must be in [0, 1)")
        self.min_share = float(min_share)
        self.hysteresis = float(hysteresis)
        self.smoothing = float(smoothing)
        self._ema: list[float] = []
        self._prev: list[tuple[int, int]] = []   # (accesses, hits) per shard
        self.rounds = 0
        self.applied = 0

    def _shares(self, weights: Sequence[float]) -> list[float]:
        total = sum(weights)
        n = len(weights)
        if total <= 0:
            return [1.0 / n] * n
        shares = [w / total for w in weights]
        # clamp to the floor, renormalize the remainder over the rest
        floor = min(self.min_share, 1.0 / n)
        excess = sum(max(0.0, s - floor) for s in shares)
        budgetable = 1.0 - floor * n
        return [floor + (max(0.0, s - floor) / excess) * budgetable
                if excess > 0 else 1.0 / n
                for s in shares]

    def rebalance(self, cache, suspended: Iterable[int] = ()) -> bool:
        """One round against a ``ShardedTwoSpaceCache``; True if resized.

        ``suspended`` names partitions whose store node is currently
        *suspected* by the failure detector: their budgets are frozen in
        place — excluded from the re-split pool on both sides — so a
        transient down verdict (traffic ceases, delta collapses) cannot
        bleed a partition's budget away only to thrash it back when the
        suspicion clears.  A *removed* node's partition (``cache.dead``)
        is the permanent case and still folds to zero."""
        stats = cache.per_shard_stats()
        n = len(stats)
        while len(self._prev) < n:          # ring grew since last round
            self._prev.append((0, 0))
        while len(self._ema) < n:
            self._ema.append(0.0)
        counters = [(s.accesses, s.hits) for s in stats]
        deltas = [max(0, a - pa) + max(0, h - ph)
                  for (a, h), (pa, ph) in zip(counters, self._prev)]
        self._prev = counters
        self.rounds += 1
        suspended = {s for s in suspended if 0 <= s < n}
        if sum(d for i, d in enumerate(deltas) if i not in suspended) == 0:
            return False
        current = cache.budgets()
        # only the unsuspended budget is in play this round
        total = sum(b for i, b in enumerate(current) if i not in suspended)
        if total <= 0:
            return False
        # a dead partition (its node left the ring — the cache flags it
        # explicitly, so a stats-delta window spanning pre-removal traffic
        # cannot masquerade as liveness) gets no share: the min_share
        # floor must not resurrect it
        dead = getattr(cache, "dead", ())
        live = [i for i in range(n)
                if i not in dead and i not in suspended
                and (current[i] > 0 or deltas[i] > 0)]
        if not live:
            return False
        live_shares = self._shares([deltas[i] for i in live])
        shares = [0.0] * n
        for i, s in zip(live, live_shares):
            shares[i] = s
        a = self.smoothing
        self._ema = [a * s + (1 - a) * e if e > 0 and s > 0 else s
                     for s, e in zip(shares, self._ema)]
        norm = sum(self._ema[i] for i in live)
        target = [total * self._ema[i] / norm if i in set(live) else 0.0
                  for i in range(n)]
        moved = max(abs(target[i] - current[i]) for i in live)
        if moved < self.hysteresis * total:
            return False
        # integer split conserving the total byte budget exactly; frozen
        # (suspended) partitions keep their current budget untouched
        mains = [int(t) for t in target]
        live_set = set(live)
        biggest = max(live, key=lambda i: mains[i])
        mains[biggest] += total - sum(mains[i] for i in live)
        for i in range(n):
            if i in suspended:
                mains[i] = current[i]
            elif i not in live_set:
                mains[i] = 0
        cache.set_budgets(mains)
        self.applied += 1
        return True
