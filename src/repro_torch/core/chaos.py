"""Deterministic, seeded fault injection for the simulated cluster.

Copied unchanged from ``src/repro/core/chaos.py``: the port keeps its
own copy and imports nothing from ``repro``.

The cluster's only faults used to be whole-node ``crash()``/``set_down``
flips scripted by hand inside each test.  This module turns faults into
*data*: a :class:`ChaosSchedule` is a list of timed :class:`Fault`
windows — network partitions between arbitrary endpoint groups, lossy /
slow / duplicating links, crash–recover sequences, clock-skewed nodes —
and a :class:`ChaosEngine` interprets that schedule at every RPC send.

Determinism is the whole point: every probabilistic decision (per-message
drop, duplicate, jitter) is drawn from a per-link ``numpy`` generator
seeded from ``(schedule seed, src, dst)``, and the simulation itself runs
on the virtual clock, so the same seed replays the *identical* fault
timeline down to each individual dropped message.  A red chaos run in CI
prints its seed; rerunning that seed locally reproduces the failure
byte-for-byte.

Endpoints are the storage node indices (ints) plus coordinator names
(strings like ``"c0"`` — see ``ShardedDKVStore.coord_name``).  The engine
is consulted at the ``backstore`` chokepoints (``get_async`` /
``multi_get_async`` / ``put`` / ``apply_replica_write`` / ``bulk_apply``
all take a ``src`` endpoint), which is also what palplint rule PALP104
polices: a direct ``Channel.issue`` send from the coordinator layer would
bypass injection entirely.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Iterable, List, Sequence, Tuple, Union

import numpy as np

Endpoint = Union[int, str]

# Fault kinds.  A schedule is heterogeneous; the engine indexes by kind.
PARTITION = "partition"
LINK = "link"
CRASH = "crash"
SKEW = "skew"


@dataclass(frozen=True)
class Fault:
    """One timed fault window ``[start, end)`` on the virtual clock."""

    kind: str
    start: float
    end: float
    # partition groups (PARTITION) or src/dst endpoint sets (LINK)
    a: Tuple[Endpoint, ...] = ()
    b: Tuple[Endpoint, ...] = ()
    # asymmetric partitions cut a->b only (acks still flow b->a)
    symmetric: bool = True
    # CRASH / SKEW target node
    node: int = -1
    # LINK per-message probabilities and delays (seconds)
    drop: float = 0.0
    delay: float = 0.0
    jitter: float = 0.0
    dup: float = 0.0
    # SKEW: fixed clock offset applied to the node's completions
    skew: float = 0.0

    def active(self, now: float) -> bool:
        return self.start <= now < self.end

    @staticmethod
    def partition(
        start: float,
        end: float,
        a: Iterable[Endpoint],
        b: Iterable[Endpoint],
        symmetric: bool = True,
    ) -> "Fault":
        return Fault(PARTITION, start, end, a=tuple(a), b=tuple(b),
                     symmetric=symmetric)

    @staticmethod
    def link(
        start: float,
        end: float,
        src: Iterable[Endpoint],
        dst: Iterable[Endpoint],
        drop: float = 0.0,
        delay: float = 0.0,
        jitter: float = 0.0,
        dup: float = 0.0,
    ) -> "Fault":
        return Fault(
            LINK, start, end, a=tuple(src), b=tuple(dst),
            drop=drop, delay=delay, jitter=jitter, dup=dup,
        )

    @staticmethod
    def crash(start: float, end: float, node: int) -> "Fault":
        return Fault(CRASH, start, end, node=node)

    @staticmethod
    def clock_skew(start: float, end: float, node: int,
                   skew: float) -> "Fault":
        return Fault(SKEW, start, end, node=node, skew=skew)


@dataclass
class ChaosSchedule:
    """A seeded, finite fault timeline.  Past ``horizon`` the world heals."""

    seed: int
    horizon: float
    faults: List[Fault] = field(default_factory=list)

    @classmethod
    def random(
        cls,
        seed: int,
        nodes: Sequence[int],
        coords: Sequence[str] = ("c0",),
        horizon: float = 1.0,
        n_partitions: int = 1,
        n_crashes: int = 1,
        n_links: int = 2,
        n_skews: int = 1,
    ) -> "ChaosSchedule":
        """Generate a plausible mixed schedule from a single seed.

        Windows are drawn inside ``[0.1*horizon, 0.9*horizon)`` so every
        run has a clean warm-up and a guaranteed heal tail; partitions
        always split the endpoint set into two non-empty groups with the
        coordinators scattered across sides (that is what produces the
        sibling-write studies).
        """
        rng = np.random.default_rng(seed)
        endpoints: List[Endpoint] = list(coords) + list(nodes)
        faults: List[Fault] = []

        def window(max_span: float = 0.4) -> Tuple[float, float]:
            t0 = float(rng.uniform(0.1, 0.7)) * horizon
            span = float(rng.uniform(0.1, max_span)) * horizon
            return t0, min(t0 + span, 0.9 * horizon)

        for _ in range(n_partitions):
            t0, t1 = window()
            sides = rng.integers(0, 2, size=len(endpoints))
            if sides.min() == sides.max():  # degenerate cut: force a split
                sides[0] = 1 - sides[0]
            ga = tuple(e for e, s in zip(endpoints, sides) if s == 0)
            gb = tuple(e for e, s in zip(endpoints, sides) if s == 1)
            faults.append(Fault.partition(
                t0, t1, ga, gb, symmetric=bool(rng.random() < 0.75)))
        for _ in range(n_crashes):
            t0, t1 = window(max_span=0.3)
            faults.append(
                Fault.crash(t0, t1, node=int(rng.choice(list(nodes)))))
        for _ in range(n_links):
            t0, t1 = window()
            src = coords[int(rng.integers(0, len(coords)))]
            dst = int(rng.choice(list(nodes)))
            faults.append(
                Fault.link(
                    t0, t1, (src,), (dst,),
                    drop=float(rng.uniform(0.05, 0.35)),
                    delay=float(rng.uniform(0.0, 2e-4)),
                    jitter=float(rng.uniform(0.0, 2e-4)),
                    dup=float(rng.uniform(0.0, 0.1)),
                )
            )
        for _ in range(n_skews):
            t0, t1 = 0.0, horizon
            faults.append(
                Fault.clock_skew(t0, t1, node=int(rng.choice(list(nodes))),
                                 skew=float(rng.uniform(0.0, 5e-4)))
            )
        return cls(seed=seed, horizon=horizon, faults=faults)


def _link_seed(seed: int, src: Endpoint, dst: Endpoint) -> int:
    """Stable per-link RNG seed: hash of (schedule seed, src, dst).

    blake2b rather than ``hash()`` because the latter is salted per
    process — replays must cross process boundaries (CI -> laptop).
    """
    h = hashlib.blake2b(f"{seed}|{src!r}|{dst!r}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big")


class ChaosEngine:
    """Interpreter for one :class:`ChaosSchedule`.

    One engine instance is shared by every coordinator and storage node
    of a cluster (``ShardedDKVStore.enable_chaos``).  All methods are
    pure functions of ``(schedule, virtual time, per-link RNG stream)``,
    so two engines built from equal schedules make identical decisions.
    """

    def __init__(self, schedule: ChaosSchedule):
        self.schedule = schedule
        self._partitions = [f for f in schedule.faults if f.kind == PARTITION]
        self._links = [f for f in schedule.faults if f.kind == LINK]
        self._crashes = [f for f in schedule.faults if f.kind == CRASH]
        self._skews = [f for f in schedule.faults if f.kind == SKEW]
        self._crash_nodes = tuple(sorted({f.node for f in self._crashes}))
        self._rngs: dict = {}
        # telemetry (deterministic per seed; surfaced by the checkers)
        self.dropped = 0
        self.duplicated = 0
        self.partition_blocks = 0
        self.delayed = 0
        #: Palpascope verdict for the most recent undelivered message:
        #: ``"partition"`` or ``"link"`` (None after a delivery).  The
        #: sender cannot tell the two apart — the trace can, which is
        #: the point: a dropped RPC span names the fault that ate it.
        self.last_drop_reason = None

    # -- deterministic (RNG-free) queries ---------------------------------

    def partitioned(self, now: float, src: Endpoint, dst: Endpoint) -> bool:
        """Is the src->dst direction cut by an active partition window?"""
        for f in self._partitions:
            if not f.active(now):
                continue
            if (src in f.a and dst in f.b) or (
                    f.symmetric and src in f.b and dst in f.a):
                return True
        return False

    def skew_of(self, now: float, node: int) -> float:
        s = 0.0
        for f in self._skews:
            if f.node == node and f.active(now):
                s += f.skew
        return s

    def crashed_now(self, now: float, node: int) -> bool:
        return any(f.node == node and f.active(now) for f in self._crashes)

    def advance(self, now: float, shards) -> None:
        """Drive scheduled crash windows onto the node stores.

        Only nodes named in a CRASH fault are chaos-owned; manual
        ``crash()`` flips on other nodes are left alone so hand-scripted
        tests compose with a schedule.
        """
        for n in self._crash_nodes:
            if 0 <= n < len(shards):
                shards[n].crashed = self.crashed_now(now, n)

    # -- per-message decisions (consume the per-link RNG stream) ----------

    def _rng(self, src: Endpoint, dst: Endpoint) -> np.random.Generator:
        key = (src, dst)
        rng = self._rngs.get(key)
        if rng is None:
            rng = np.random.default_rng(
                _link_seed(self.schedule.seed, src, dst))
            self._rngs[key] = rng
        return rng

    def on_send(
        self, now: float, src: Endpoint, dst: Endpoint
    ) -> Tuple[bool, float, int]:
        """Adjudicate one message on the src->dst link.

        Returns ``(delivered, extra_delay, duplicates)``.  Partition cuts
        and drops are indistinguishable to the sender (a missing ack);
        duplicates model at-least-once retransmission and cost the
        receiver wasted service; reorder falls out of per-message jitter
        (two back-to-back sends can complete out of order).
        """
        self.last_drop_reason = None
        if self.partitioned(now, src, dst):
            self.partition_blocks += 1
            self.last_drop_reason = "partition"
            return False, 0.0, 0
        delay = 0.0
        dups = 0
        for f in self._links:
            if not f.active(now):
                continue
            if src not in f.a or dst not in f.b:
                continue
            rng = self._rng(src, dst)
            if f.drop > 0.0 and rng.random() < f.drop:
                self.dropped += 1
                self.last_drop_reason = "link"
                return False, 0.0, 0
            if f.delay > 0.0 or f.jitter > 0.0:
                delay += f.delay + (f.jitter * float(rng.random())
                                    if f.jitter > 0.0 else 0.0)
            if f.dup > 0.0 and rng.random() < f.dup:
                dups += 1
                self.duplicated += 1
        if isinstance(dst, int):
            delay += self.skew_of(now, dst)
        if delay > 0.0:
            self.delayed += 1
        return True, delay, dups

    def stats(self) -> dict:
        return {
            "dropped": self.dropped,
            "duplicated": self.duplicated,
            "partition_blocks": self.partition_blocks,
            "delayed": self.delayed,
        }


__all__ = [
    "Fault",
    "ChaosSchedule",
    "ChaosEngine",
    "PARTITION",
    "LINK",
    "CRASH",
    "SKEW",
]
