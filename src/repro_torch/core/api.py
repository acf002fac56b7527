"""The unified client surface (ROADMAP: one API in front of the cluster).

Copied unchanged from ``src/repro/core/api.py``: the port keeps its own
copy and imports nothing from ``repro``.

Three client families grew up side by side — ``PalpatineClient`` /
``BaselineClient`` against a (sharded) DKV store, ``ClusterClient``
tenants driven by the interleaving heap, and the serving stack's
``ExpertPrefetcher`` with its own private ``access(layer, expert)``
entry point.  This module names the one protocol they all speak, so the
load generator, the benchmarks, and the contract suite can drive any of
them interchangeably:

  read(container)        -> (value, virtual latency)
  read_many(containers)  -> (values, batch latency)
  write(container, v)    -> foreground latency
  end_session()          -> explicit session cut (request/transaction end)
  mine_now()             -> re-mine the logged backlog, returns #patterns
  stats                  -> cache/serving counters (dict- or
                            CacheStats-shaped snapshot)

Deprecation policy: old entry points stay as thin shims that delegate to
the protocol surface (``ExpertPrefetcher.access`` -> ``read``) for at
least one PR cycle after their replacement lands, and carry a
"deprecated" docstring note pointing at the replacement.  New call sites
must use the protocol methods.
"""

from __future__ import annotations

from typing import Any, Protocol, Sequence, runtime_checkable

__all__ = ["Client"]


@runtime_checkable
class Client(Protocol):
    """What every Palpatine-backed client exposes.

    ``runtime_checkable`` so the contract suite can assert conformance
    with ``isinstance`` (structural: methods present, not signatures);
    the shared behavioural contract lives in
    ``tests/test_api_contract.py``.
    """

    def read(self, container) -> tuple[Any, float]:
        """One monitored read: (value, virtual latency)."""
        ...

    def read_many(self, containers: Sequence) -> tuple[list, float]:
        """Batched read with overlapped in-flight fetches."""
        ...

    def write(self, container, value) -> float:
        """Write-through update; returns the foreground latency."""
        ...

    def end_session(self) -> None:
        """Explicit session cut (end of a request/transaction)."""
        ...

    def mine_now(self, use_dynamic_minsup: bool = True) -> int:
        """Mine the logged backlog into the pattern metastore."""
        ...

    @property
    def stats(self):
        """Cache/serving counter snapshot."""
        ...
