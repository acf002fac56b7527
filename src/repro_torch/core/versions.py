"""Dotted version vectors for partition-tolerant causality.

Copied unchanged from ``src/repro/core/versions.py``: the port keeps its
own copy and imports nothing from ``repro``.

The cluster's original versioning scheme was a single monotone counter
per coordinator: good enough while exactly one coordinator stamps every
write, silently wrong the moment two coordinators write the same key on
opposite sides of a partition (both mint the same integer, the heal sees
"equal versions", and one acked write is dropped without a trace).

A :class:`DottedVersion` fixes that with the classic dotted-version-
vector construction:

* the **dot** is this write's unique event id — ``(counter, coord)``
  where ``counter`` is the stamping coordinator's monotone write counter
  and ``coord`` its integer id;
* the **clock** is the causal context the coordinator observed when it
  stamped the write — a pointwise-max map ``coord -> counter`` over the
  versions visible on the replicas the write will land on.

``a.descends(b)`` iff ``b``'s dot is inside ``a``'s causal history;
two versions where neither descends the other are **siblings**
(concurrent writes), and :func:`merge` resolves them deterministically:
last-writer-wins **by dot** (highest ``(counter, coord)`` pair picks the
surviving value) while the merged clock keeps *every* dot, so neither
write is silently forgotten — the loser is recorded as superseded, not
lost.

Interop contract: the rest of the repo still compares versions with
``<``/``<=``/``max`` and uses ``0`` for "absent".  Plain ints therefore
remain valid versions (legacy ``versioning='counter'`` mode and
hand-written tests) and order against dotted versions through the same
sort key — an int ``n`` behaves as the dot ``(n, -1)`` with an empty
clock, which every real coordinator dot (coord id >= 0) beats on ties.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Tuple, Union

Version = Union[int, "DottedVersion"]

# sort key of a plain-int legacy version n: dot (n, coord=-1), empty clock
_LEGACY_COORD = -1


def sort_key(v: Version) -> Tuple[int, int, Tuple[Tuple[int, int], ...]]:
    """Total order over versions: (counter, coord, clock) lexicographic.

    The first two components are the dot — so last-writer-wins-by-dot is
    literally ``max(versions, key=sort_key)`` — and the clock breaks the
    residual tie between "same dot, smaller context" states that read
    repair creates while it is upgrading a winner's clock in place.
    """
    if isinstance(v, DottedVersion):
        return (v.dot[0], v.dot[1], v.clock)
    return (int(v), _LEGACY_COORD, ())


@dataclass(frozen=True)
class DottedVersion:
    """One write event: a dot ``(counter, coord)`` plus its causal clock.

    ``clock`` is stored as a sorted tuple of ``(coord, counter)`` pairs so
    the value is immutable, hashable, and has a canonical repr (the chaos
    fingerprint hashes it byte-for-byte).
    """

    dot: Tuple[int, int]  # (counter, coord)
    clock: Tuple[Tuple[int, int], ...] = ()

    @staticmethod
    def stamp(coord: int, counter: int,
              context: Iterable[Version] = ()) -> "DottedVersion":
        """Mint the version for a new write by coordinator ``coord``.

        ``context`` is whatever versions the coordinator could *see* on
        the replicas it is about to write: the new clock is their
        pointwise max plus this write's own dot.  Writes stamped on
        opposite sides of a partition see disjoint contexts and come out
        as siblings; sequential writes see each other and chain.
        """
        merged: dict[int, int] = {}
        for v in context:
            if isinstance(v, DottedVersion):
                for c, n in v.clock:
                    if n > merged.get(c, 0):
                        merged[c] = n
                dc, dn = v.dot[1], v.dot[0]
                if dn > merged.get(dc, 0):
                    merged[dc] = dn
            elif int(v) > merged.get(_LEGACY_COORD, 0):
                merged[_LEGACY_COORD] = int(v)
        if counter > merged.get(coord, 0):
            merged[coord] = counter
        return DottedVersion(
            dot=(counter, coord),
            clock=tuple(sorted(merged.items())),
        )

    def seen(self, counter: int, coord: int) -> bool:
        """Is the event ``(counter, coord)`` inside this causal history?"""
        if coord == self.dot[1] and counter <= self.dot[0]:
            return True
        for c, n in self.clock:
            if c == coord:
                return counter <= n
        return False

    def counter_of(self, coord: int) -> int:
        """Highest ``coord`` counter inside this causal history (0 if
        none) — what a restarting coordinator resumes its dot counter
        past, so dots stay unique across crash-restarts."""
        n = self.dot[0] if self.dot[1] == coord else 0
        for c, m in self.clock:
            if c == coord and m > n:
                n = m
        return n

    def descends(self, other: Version) -> bool:
        """True iff ``other`` is in this version's causal past (or equal)."""
        if isinstance(other, DottedVersion):
            return self.seen(other.dot[0], other.dot[1])
        # legacy int: 0 is "absent" (everything descends it); a hand-set
        # positive int orders by the interop sort key
        return int(other) <= 0 or sort_key(self) >= sort_key(other)

    # rich comparisons over the total sort key keep every pre-existing
    # `ver <= node.versions.get(k, 0)` / `max(vers)` call site working
    # unchanged when versions become dotted
    def __lt__(self, other: Version) -> bool:
        return sort_key(self) < sort_key(other)

    def __le__(self, other: Version) -> bool:
        return sort_key(self) <= sort_key(other)

    def __gt__(self, other: Version) -> bool:
        return sort_key(self) > sort_key(other)

    def __ge__(self, other: Version) -> bool:
        return sort_key(self) >= sort_key(other)


def descends(a: Version, b: Version) -> bool:
    """Causality check that tolerates legacy int versions on either side."""
    if isinstance(a, DottedVersion):
        return a.descends(b)
    if isinstance(b, DottedVersion):
        # a plain int never truly saw a dotted write; order by sort key so
        # counter-mode clusters keep their old monotone behaviour
        return sort_key(a) >= sort_key(b)
    return int(a) >= int(b)


def concurrent(a: Version, b: Version) -> bool:
    """Siblings: neither version descends the other."""
    return not descends(a, b) and not descends(b, a)


def merge(versions: Iterable[Version]) -> Version:
    """Deterministic sibling resolution: last-writer-wins **by dot**.

    The surviving dot is the max sort key; the merged clock is the
    pointwise max over every participant's clock *and* dot, so each
    sibling's event stays inside the survivor's causal history (that is
    what lets the invariant checker prove "no acked write silently
    lost": its dot must appear in the final clock).
    """
    vs = list(versions)
    if not vs:
        return 0
    winner = max(vs, key=sort_key)
    if not isinstance(winner, DottedVersion):
        return winner
    merged: dict[int, int] = {}
    for v in vs:
        if isinstance(v, DottedVersion):
            for c, n in v.clock:
                if n > merged.get(c, 0):
                    merged[c] = n
            dn, dc = v.dot
            if dn > merged.get(dc, 0):
                merged[dc] = dn
        elif int(v) > merged.get(_LEGACY_COORD, 0):
            merged[_LEGACY_COORD] = int(v)
    return DottedVersion(dot=winner.dot, clock=tuple(sorted(merged.items())))
