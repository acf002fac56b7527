"""Pattern Metastore (Palpatine §3.2 "Data post-processing", §4.1 steps e/f).

Copied unchanged from ``src/repro/core/metastore.py``: the port keeps
its own copy and imports nothing from ``repro``.

Bounds metadata memory: when the miner discovers more sequences than the
capacity, keep the top ones ranked by ``length × support`` (the larger the
sequence and the higher its support, the better).

The same merge-board idiom carries the cluster's *failure verdicts*
(:class:`VerdictBoard`): like mined patterns, verdicts are small records
each coordinator produces locally and everyone benefits from sharing —
gossiped through ``cluster.VerdictExchange`` exactly the way patterns
travel through ``cluster.PatternExchange``.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Sequence

from .mining import Pattern

__all__ = ["PatternMetastore", "VerdictBoard"]


class PatternMetastore:
    def __init__(self, capacity: int = 10_000, max_pattern_len: int = 15):
        self.capacity = int(capacity)
        self.max_pattern_len = int(max_pattern_len)
        self.patterns: list[Pattern] = []
        self.generation = 0  # bumped on every (re)population

    @staticmethod
    def rank(p: Pattern) -> float:
        return len(p.items) * p.support

    def populate(self, patterns: Iterable[Pattern]) -> None:
        """Replace contents with the top-ranked patterns (fresh mining run)."""
        pats = [p for p in patterns if len(p.items) <= self.max_pattern_len]
        pats.sort(key=self.rank, reverse=True)
        self.patterns = pats[: self.capacity]
        self.generation += 1

    def merge(self, patterns: Iterable[Pattern]) -> None:
        """Gossip merge (cluster pattern exchange): union by items, keeping
        the highest observed support per sequence, then re-rank and truncate
        to capacity."""
        best: dict = {p.items: p for p in self.patterns}
        for p in patterns:
            if len(p.items) > self.max_pattern_len:
                continue
            q = best.get(p.items)
            if q is None or p.support > q.support:
                best[p.items] = p
        pats = sorted(best.values(), key=self.rank, reverse=True)
        self.patterns = pats[: self.capacity]
        self.generation += 1

    def add_apriori(self, sequences: Sequence[Sequence[int]], support: int = 1) -> None:
        """Paper §4.1: apriori-known sequences may be stored alongside the
        mined ones."""
        merged = self.patterns + [Pattern(tuple(s), support) for s in sequences]
        merged.sort(key=self.rank, reverse=True)
        self.patterns = merged[: self.capacity]
        self.generation += 1

    def __len__(self) -> int:
        return len(self.patterns)

    def __iter__(self):
        return iter(self.patterns)


class VerdictBoard:
    """Latest-wins record board for gossiped failure verdicts.

    One record per storage node: ``(stamp, coord, suspected, phi)`` where
    ``stamp`` is the publishing detector's Lamport flip stamp and
    ``coord`` the publishing coordinator's id.  Freshness order is
    ``(stamp, coord)`` — the coordinator id breaks Lamport ties
    deterministically — so any set of boards merges to the same fixed
    point regardless of gossip order or pairing: the convergence property
    the two-coordinators-disagree partition study relies on.
    """

    def __init__(self) -> None:
        # node -> (stamp, coord, suspected, phi)
        self.records: dict[int, tuple[int, int, bool, float]] = {}
        self.published = 0
        self.merges = 0

    def _put(self, node: int, rec: tuple[int, int, bool, float]) -> bool:
        cur = self.records.get(node)
        if cur is None or (rec[0], rec[1]) > (cur[0], cur[1]):
            self.records[node] = rec
            return True
        return False

    def publish(self, coord: int,
                verdicts: Mapping[int, tuple[int, bool, float]]) -> int:
        """Fold one detector's exported verdicts in under ``coord``'s id."""
        n = 0
        for node in sorted(verdicts):
            stamp, suspected, phi = verdicts[node]
            n += int(self._put(node, (stamp, int(coord), bool(suspected),
                                      float(phi))))
        self.published += n
        return n

    def merge(self, other: "VerdictBoard") -> int:
        """Pairwise gossip merge: adopt every fresher record."""
        n = 0
        for node in sorted(other.records):
            n += int(self._put(node, other.records[node]))
        self.merges += 1
        return n

    def snapshot(self) -> list[tuple[int, tuple[int, int, bool, float]]]:
        """Deterministically ordered records for adoption sweeps."""
        return sorted(self.records.items())

    def __len__(self) -> int:
        return len(self.records)
