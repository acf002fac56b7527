"""Two-space KV cache (Palpatine §4.4).

Copied unchanged from ``src/repro/core/cache.py``: the port keeps its
own copy and imports nothing from ``repro``.

Two independent LRU spaces: the *main* space holds demand-fetched items, the
*preemptive* space holds prefetched items (a configurable fraction of the
main size, 10 % by default).  The separation bounds cache pollution: useless
prefetches can only churn the preemptive space.  A first access to a
prefetched item counts as a *prefetch hit* and promotes it to the main space;
later accesses are plain cache hits (paper §5.2 "Accuracy").
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Optional

from .obs import AttributionTable

__all__ = ["CacheStats", "LRUSpace", "TwoSpaceCache"]


@dataclasses.dataclass
class CacheStats:
    accesses: int = 0
    hits: int = 0                # all accesses served by cache (both spaces)
    misses: int = 0
    prefetches: int = 0          # prefetched items admitted
    prefetch_hits: int = 0       # first access to a prefetched item
    prefetch_waits: int = 0      # prefetch hit arrived while still in flight
    invalidations: int = 0
    writes: int = 0

    @property
    def hit_rate(self) -> float:
        return self.hits / self.accesses if self.accesses else 0.0

    @property
    def precision(self) -> float:
        return self.prefetch_hits / self.prefetches if self.prefetches else 0.0


@dataclasses.dataclass
class _Entry:
    value: Any
    size: int
    available_at: float = 0.0    # prefetch completion time (virtual clock)
    cause: Any = None            # PrefetchCause for attribution (or None)


class LRUSpace:
    """Byte-capacity LRU.  ``evict_cb``, when set, observes every
    capacity eviction as ``(key, entry)`` — the attribution hook for
    prefetched-but-never-touched entries leaving the preemptive space."""

    def __init__(self, capacity_bytes: int):
        self.capacity = int(capacity_bytes)
        self.used = 0
        self.od: "OrderedDict[Any, _Entry]" = OrderedDict()
        self.evict_cb = None

    def __contains__(self, key) -> bool:
        return key in self.od

    def __len__(self) -> int:
        return len(self.od)

    def get(self, key) -> Optional[_Entry]:
        e = self.od.get(key)
        if e is not None:
            self.od.move_to_end(key)
        return e

    def peek(self, key) -> Optional[_Entry]:
        return self.od.get(key)

    def put(self, key, entry: _Entry) -> list:
        """Insert/replace; returns evicted keys."""
        old = self.od.pop(key, None)
        if old is not None:
            self.used -= old.size
        if entry.size > self.capacity:
            # cannot fit at all (incl. capacity == 0) — but any previous
            # entry under this key is already gone: keeping it would serve
            # the superseded value on the next lookup
            return []
        self.od[key] = entry
        self.used += entry.size
        evicted = []
        while self.used > self.capacity:
            k, e = self.od.popitem(last=False)
            self.used -= e.size
            evicted.append(k)
            if self.evict_cb is not None:
                self.evict_cb(k, e)
        return evicted

    def remove(self, key) -> bool:
        e = self.od.pop(key, None)
        if e is not None:
            self.used -= e.size
            return True
        return False

    def resize(self, capacity_bytes: int) -> list:
        """Change the byte budget in place (cluster budget rebalancing).
        Shrinking evicts LRU-first down to the new capacity; returns the
        evicted keys."""
        self.capacity = int(capacity_bytes)
        evicted = []
        while self.used > self.capacity:
            k, e = self.od.popitem(last=False)
            self.used -= e.size
            evicted.append(k)
            if self.evict_cb is not None:
                self.evict_cb(k, e)
        return evicted


class TwoSpaceCache:
    def __init__(self, main_bytes: int, preemptive_frac: float = 0.10):
        self.preemptive_frac = float(preemptive_frac)
        self.main = LRUSpace(main_bytes)
        self.preemptive = LRUSpace(int(main_bytes * preemptive_frac))
        self.stats = CacheStats()
        # per-pattern prefetch attribution (Palpascope): every admitted
        # prefetch ends up hit, unused, or resident — the table's hit
        # sum equals stats.prefetch_hits exactly (tier-1 pinned)
        self.attr = AttributionTable()
        self.preemptive.evict_cb = self._prefetch_evicted

    def _prefetch_evicted(self, key, e: _Entry) -> None:
        self.attr.record_unused(e.cause, e.size)

    def reset_attr(self) -> None:
        self.attr = AttributionTable()

    def resize(self, main_bytes: int) -> None:
        """Re-budget both spaces, keeping the preemptive fraction; overflow
        evicts LRU-first (the rebalancer shrinks cold partitions live)."""
        self.main.resize(main_bytes)
        self.preemptive.resize(int(main_bytes * self.preemptive_frac))

    # -- reads ---------------------------------------------------------
    def lookup(self, key, now: float = 0.0):
        """Returns ``(value, wait)`` on hit, ``None`` on miss.

        ``wait`` > 0 means the item was prefetched but is still in flight;
        the caller blocks for the remainder (paper: timeliness).
        """
        self.stats.accesses += 1
        e = self.main.get(key)
        if e is not None:
            self.stats.hits += 1
            return e.value, 0.0
        e = self.preemptive.peek(key)
        if e is not None:
            # first touch of a prefetched item: prefetch hit + promotion
            self.preemptive.remove(key)
            wait = max(0.0, e.available_at - now)
            self.stats.hits += 1
            self.stats.prefetch_hits += 1
            self.attr.record_hit(e.cause, e.size)
            if wait > 0:
                self.stats.prefetch_waits += 1
            self.main.put(key, _Entry(e.value, e.size))
            return e.value, wait
        self.stats.misses += 1
        return None

    def contains(self, key) -> bool:
        return key in self.main or key in self.preemptive

    # -- fills -----------------------------------------------------------
    def put_demand(self, key, value, size: int) -> None:
        old = self.preemptive.peek(key)
        if old is not None:
            # a demand fetch raced the prefetched copy: the prefetch
            # never got its first touch — pure waste
            self.attr.record_unused(old.cause, old.size)
        self.preemptive.remove(key)
        self.main.put(key, _Entry(value, size))

    def put_prefetch(self, key, value, size: int, available_at: float,
                     cause=None) -> bool:
        """Admit a prefetched item (skips items already cached).  Returns
        True if admitted (counted against precision)."""
        if key in self.main or key in self.preemptive:
            return False
        self.stats.prefetches += 1
        self.attr.record_prefetch(cause, size)
        self.preemptive.put(key, _Entry(value, size, available_at, cause))
        if key not in self.preemptive:
            # too big for the preemptive budget: dropped on arrival
            self.attr.record_unused(cause, size)
        return True

    # -- writes & coherence ----------------------------------------------
    def write(self, key, value, size: int) -> None:
        """Write-through update: replace the value in place, treating the
        item as most recent (paper §4.4)."""
        self.stats.writes += 1
        if key in self.preemptive:
            # keep the attribution tag: presence is still owed to the
            # prefetch, even though the value was just superseded
            old = self.preemptive.peek(key)
            self.preemptive.put(key, _Entry(value, size, cause=old.cause))
            if key not in self.preemptive:
                self.attr.record_unused(old.cause, old.size)
        else:
            self.main.put(key, _Entry(value, size))

    def invalidate(self, key) -> None:
        """Coherence notification from the store-side monitor (another
        client wrote this item)."""
        old = self.preemptive.peek(key)
        if old is not None:
            self.attr.record_unused(old.cause, old.size)
        removed = self.main.remove(key) | self.preemptive.remove(key)
        if removed:
            self.stats.invalidations += 1
