"""Palpascope observability layer: causal tracing, metrics, attribution.

Copied unchanged from ``src/repro/core/obs.py``: the port keeps its own
copy and imports nothing from ``repro``.

Zero-dependency (stdlib + the simulation's own virtual clocks) and
off by default: every request-path hook goes through a module-level
:data:`NULL_TRACER` whose methods are constant-returning no-ops, so an
untraced run pays a handful of attribute lookups per op (gated in
``bench_overhead.py`` as ``tracing_overhead_ratio``).

Three instruments, one module:

* **Causal tracing** — a :class:`Span` tree per client op, threaded
  through coordinator routing, node RPCs, cache lookups, the decision
  engine, and background prefetch issue.  Spans are stamped with
  *virtual* time (the simulation's clocks, never the host's), carry a
  ``status`` (chaos-dropped RPCs are marked ``dropped``), and nest: a
  child's ``[start, end]`` interval always lies inside its parent's —
  :meth:`Tracer.end` closes any still-open interval at the maximum of
  its children, so the invariant holds even when a traced region exits
  through an exception (unavailability ``KeyError`` under chaos is a
  legal outcome, not a leak).  Completed traces land in a bounded ring
  buffer, exportable as JSON for ``tools/palpascope.py``.
* **Metrics registry** — typed counters / gauges and fixed-bucket
  latency histograms with deterministic p50/p99/p999, registered by
  constant name (palplint PALP301 rejects computed names inside
  ``src/repro/core``: metric/span names must be the ``SPAN_*`` /
  ``EVENT_*`` / ``METRIC_*`` constants below, which keeps label
  cardinality finite by construction).
* **Prefetch attribution** — every background fetch carries the
  :class:`PrefetchCause` (pattern root, pattern length, heuristic,
  confidence) that emitted it; the cache feeds an
  :class:`AttributionTable` recording per-pattern prefetched / hit /
  evicted-unused mass, so the benches can export ``attr_*`` keys and
  the sum of per-pattern hits provably equals the cache's
  ``prefetch_hits`` counter (pinned by a tier-1 test).

Sampling: ``Tracer(sample=1/N, seed=...)`` keeps a deterministic 1-in-N
subset of root spans — the selection is a pure function of ``(seed,
root ordinal)``, so two tracers with the same seed over the same
workload capture byte-identical traces (chaoscheck replays depend on
this).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from collections import deque
from typing import Any, Iterable, Optional, Sequence

__all__ = [
    "Span", "Tracer", "NullTracer", "NULL_TRACER", "NULL_SPAN",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "percentile", "latency_percentiles",
    "PrefetchCause", "AttributionTable",
    "span_kind_breakdown", "critical_path",
]

# ---------------------------------------------------------------------------
# Registered name table (the constant table palplint PALP301 checks
# against: span/event/metric names in src/repro/core must be these
# constants — never f-strings or ad-hoc literals, so cardinality stays
# finite and palpascope can key breakdowns by a closed vocabulary).
# ---------------------------------------------------------------------------

# span kinds
SPAN_OP = "op"                        # one client read/write/read_many
SPAN_CACHE = "cache_lookup"
SPAN_DEMAND = "demand_fetch"
SPAN_DECISION = "decision"
SPAN_PREFETCH = "prefetch_issue"
SPAN_ROUTE = "route"                  # coordinator routing + retry loop
SPAN_RPC = "rpc"                      # one message onto a node's channel
SPAN_SERVICE = "service"              # node-side service interval
SPAN_WRITE = "write"                  # coordinator replicated write
SPAN_MEMBERSHIP = "membership_move"   # ring-change range transfer

# zero-duration events attached to the innermost open span
EVENT_HINT = "hint"
EVENT_SLOPPY = "sloppy_write"
EVENT_READ_REPAIR = "read_repair"
EVENT_QUORUM = "quorum"
EVENT_RETRY = "retry"
EVENT_CHAOS_DROP = "chaos_drop"
EVENT_CHAOS_DELAY = "chaos_delay"
EVENT_CHAOS_DUP = "chaos_dup"
EVENT_PROBE = "probe"
EVENT_SHED = "prefetch_shed"

# metric names (registry keys; benches snapshot these per phase)
METRIC_READ_LATENCY = "read_latency_s"
METRIC_OPS = "ops"
METRIC_PREFETCH_ISSUED = "prefetch_issued"
METRIC_PREFETCH_HITS = "prefetch_hits"
METRIC_RPC_TIMEOUTS = "rpc_timeouts"
METRIC_STALE_READS = "stale_reads"
METRIC_DEMAND_WAIT = "demand_wait_s"
METRIC_STORE_FETCHES = "store_fetches"
METRIC_SESSIONS = "sessions"
METRIC_PREFILL_S = "prefill_s"
METRIC_DECODE_S = "decode_s"
METRIC_TOKENS = "tokens"

REGISTERED_NAMES = frozenset(
    v for k, v in list(globals().items())
    if k.startswith(("SPAN_", "EVENT_", "METRIC_")) and isinstance(v, str)
)


# ---------------------------------------------------------------------------
# Spans + tracer
# ---------------------------------------------------------------------------


class Span:
    """One timed interval on the virtual clock.  ``fields`` and
    ``children`` are lazily allocated — an annotation-free span is three
    floats and two Nones."""

    __slots__ = ("kind", "start", "end", "status", "fields", "children")
    live = True

    def __init__(self, kind: str, start: float):
        self.kind = kind
        self.start = float(start)
        self.end: Optional[float] = None
        self.status = "ok"
        self.fields: Optional[dict] = None
        self.children: Optional[list] = None

    # -- annotation ------------------------------------------------------
    def set(self, **fields) -> "Span":
        if self.fields is None:
            self.fields = fields
        else:
            self.fields.update(fields)
        return self

    def mark(self, status: str) -> "Span":
        self.status = status
        return self

    def finish(self, t: float) -> "Span":
        self.end = float(t)
        return self

    def _attach(self, child: "Span") -> None:
        if self.children is None:
            self.children = [child]
        else:
            self.children.append(child)

    # -- queries ---------------------------------------------------------
    @property
    def duration(self) -> float:
        return (self.end if self.end is not None else self.start) - self.start

    def walk(self) -> Iterable["Span"]:
        yield self
        for c in self.children or ():
            yield from c.walk()

    def to_dict(self) -> dict:
        d: dict = {"kind": self.kind, "start": self.start,
                   "end": self.end if self.end is not None else self.start,
                   "status": self.status}
        if self.fields:
            d["fields"] = {k: _jsonable(v) for k, v in self.fields.items()}
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return repr(v)


class _NullSpan(Span):
    """The do-nothing span singleton: every mutator is a constant-return
    no-op, so untraced hot paths cost one method call per hook."""

    __slots__ = ()
    live = False

    def __init__(self):
        super().__init__("null", 0.0)

    def set(self, **fields) -> "Span":
        return self

    def mark(self, status: str) -> "Span":
        return self

    def finish(self, t: float) -> "Span":
        return self

    def _attach(self, child: "Span") -> None:
        pass


NULL_SPAN = _NullSpan()


class NullTracer:
    """Tracing disabled: the default on every store and client.  All
    methods return :data:`NULL_SPAN` or do nothing."""

    active = False
    sample = 0.0

    def start(self, kind: str, t: float) -> Span:
        return NULL_SPAN

    def span(self, kind: str, t: float) -> Span:
        return NULL_SPAN

    def event(self, name: str, t: float, **fields) -> None:
        return None

    def end(self, span: Span, t: Optional[float] = None) -> None:
        return None


NULL_TRACER = NullTracer()


def _sample_hash(seed: int, n: int) -> float:
    """Deterministic uniform draw in [0, 1) for root ordinal ``n`` —
    blake2b, not ``hash()``, so the same seed selects the same traces
    across processes (CI -> laptop replays)."""
    h = hashlib.blake2b(f"{seed}|{n}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big") / 2.0 ** 64


class Tracer:
    """Collects span trees rooted at client/coordinator ops.

    Single-threaded by construction (the simulation is), so causal
    context is a plain stack: :meth:`span` nests under the innermost
    open span, :meth:`start` opens a root (or nests, when called inside
    an already-open trace — a store-level op under a client op).
    Completed traces land in a bounded ring buffer (``capacity``).
    """

    active = True

    def __init__(self, sample: float = 1.0, seed: int = 0,
                 capacity: int = 256):
        self.sample = float(sample)
        self.seed = int(seed)
        self.traces: deque = deque(maxlen=int(capacity))
        self.roots_seen = 0          # root candidates (sampling ordinal)
        self.roots_kept = 0
        self._stack: list[Span] = []

    # -- span lifecycle --------------------------------------------------
    def start(self, kind: str, t: float) -> Span:
        """Open a root span (sampled) or, mid-trace, a child span."""
        if self._stack:
            return self.span(kind, t)
        self.roots_seen += 1
        if self.sample < 1.0 and \
                _sample_hash(self.seed, self.roots_seen) >= self.sample:
            return NULL_SPAN
        self.roots_kept += 1
        sp = Span(kind, t)
        self._stack.append(sp)
        return sp

    def span(self, kind: str, t: float) -> Span:
        """Open a child of the innermost open span; no-op outside a
        sampled trace."""
        if not self._stack:
            return NULL_SPAN
        sp = Span(kind, t)
        self._stack[-1]._attach(sp)
        self._stack.append(sp)
        return sp

    def event(self, name: str, t: float, **fields) -> None:
        """Zero-duration annotation on the innermost open span."""
        if not self._stack:
            return
        ev = Span(name, t)
        ev.end = float(t)
        ev.status = "event"
        if fields:
            ev.fields = fields
        self._stack[-1]._attach(ev)

    def end(self, span: Span, t: Optional[float] = None) -> None:
        """Close ``span``: pop it, defaulting the end time to the latest
        child end (so exception exits still close every interval), and
        clamp it to cover its children (the nesting invariant)."""
        if span is NULL_SPAN or not self._stack:
            return
        top = self._stack.pop()
        # disciplined try/finally call sites keep this LIFO; a mismatch
        # would mean an unbalanced site, surfaced loudly in tests
        assert top is span, f"unbalanced span end: {span.kind} vs {top.kind}"
        end = span.end if t is None else float(t)
        floor = span.start
        for c in span.children or ():
            if c.end is not None and c.end > floor:
                floor = c.end
        span.end = floor if end is None else max(end, floor)
        if not self._stack:
            self.traces.append(span)

    # -- export ----------------------------------------------------------
    @property
    def open_spans(self) -> int:
        return len(self._stack)

    def export(self) -> dict:
        return {"sample": self.sample, "seed": self.seed,
                "roots_seen": self.roots_seen,
                "roots_kept": self.roots_kept,
                "traces": [t.to_dict() for t in self.traces]}

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.export(), f, indent=1, sort_keys=True)


# ---------------------------------------------------------------------------
# Trace analysis (shared by tools/palpascope.py and the benches)
# ---------------------------------------------------------------------------


def _as_dict(span) -> dict:
    return span.to_dict() if isinstance(span, Span) else span


def span_kind_breakdown(traces: Sequence) -> dict[str, dict]:
    """Per-span-kind latency breakdown over exported trace dicts (or
    live Spans): count, total/mean virtual seconds, p50/p99."""
    by_kind: dict[str, list[float]] = {}
    def visit(d: dict) -> None:
        if d.get("status") != "event":
            by_kind.setdefault(d["kind"], []).append(
                d.get("end", d["start"]) - d["start"])
        for c in d.get("children", ()):
            visit(c)
    for t in traces:
        visit(_as_dict(t))
    out = {}
    for kind in sorted(by_kind):
        durs = by_kind[kind]
        out[kind] = {
            "count": len(durs),
            "total_s": sum(durs),
            "mean_s": sum(durs) / len(durs),
            "p50_s": percentile(durs, 50.0),
            "p99_s": percentile(durs, 99.0),
        }
    return out


def critical_path(trace) -> list[dict]:
    """The chain of spans that determines the root's completion time:
    from the root, repeatedly descend into the child whose end time
    matches the parent's frontier.  Returns one row per hop with the
    span's self time (its duration minus the part explained by the
    next hop)."""
    node = _as_dict(trace)
    path = []
    while True:
        end = node.get("end", node["start"])
        kids = [c for c in node.get("children", ())
                if c.get("status") != "event"]
        nxt = None
        for c in kids:
            ce = c.get("end", c["start"])
            if nxt is None or ce > nxt.get("end", nxt["start"]):
                nxt = c
        dur = end - node["start"]
        child_dur = (nxt.get("end", nxt["start"]) - nxt["start"]
                     if nxt is not None else 0.0)
        path.append({
            "kind": node["kind"], "status": node.get("status", "ok"),
            "start": node["start"], "end": end,
            "duration_s": dur, "self_s": max(0.0, dur - child_dur),
            "fields": node.get("fields", {}),
        })
        if nxt is None:
            return path
        node = nxt


# ---------------------------------------------------------------------------
# Percentiles + histograms
# ---------------------------------------------------------------------------


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (the one canonical definition all benches
    share; ``bench_cluster`` and ``bench_overhead`` used to disagree on
    interpolation).  ``q`` in [0, 100]."""
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q={q!r} outside [0, 100]")
    vs = sorted(values)
    if not vs:
        return 0.0
    rank = math.ceil(q / 100.0 * len(vs))
    return float(vs[max(0, rank - 1)])


def latency_percentiles(values: Sequence[float]) -> dict[str, float]:
    """The standard p50/p99/p999 triple, nearest-rank."""
    vs = sorted(values)
    if not vs:
        return {"p50": 0.0, "p99": 0.0, "p999": 0.0}
    def at(q: float) -> float:
        return float(vs[max(0, math.ceil(q / 100.0 * len(vs)) - 1)])
    return {"p50": at(50.0), "p99": at(99.0), "p999": at(99.9)}


class Counter:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


def default_latency_buckets() -> list[float]:
    """96 log-spaced bucket upper bounds, 1 µs to ~40 s (ratio 1.2):
    fine enough that a bucketed p99 lands within ~20 % of exact, fixed
    so histograms from different phases/runs are mergeable."""
    return [1e-6 * 1.2 ** i for i in range(96)]


class Histogram:
    """Fixed-bucket latency histogram over virtual seconds.

    Bucketed percentiles are deterministic (they return the upper bound
    of the bucket holding the nearest-rank sample — never an
    interpolated value two runs could disagree on) and mergeable across
    phases.  Exact sample-level percentiles are :func:`percentile`'s
    job; the regression test pins both on a known sample.
    """

    __slots__ = ("name", "bounds", "counts", "count", "total", "vmax")

    def __init__(self, name: str, bounds: Optional[Sequence[float]] = None):
        self.name = name
        self.bounds = list(bounds) if bounds is not None \
            else default_latency_buckets()
        if sorted(self.bounds) != self.bounds:
            raise ValueError("histogram bounds must be sorted")
        self.counts = [0] * (len(self.bounds) + 1)  # +1 overflow bucket
        self.count = 0
        self.total = 0.0
        self.vmax = 0.0

    def record(self, v: float) -> None:
        lo, hi = 0, len(self.bounds)
        while lo < hi:
            mid = (lo + hi) // 2
            if v <= self.bounds[mid]:
                hi = mid
            else:
                lo = mid + 1
        self.counts[lo] += 1
        self.count += 1
        self.total += v
        if v > self.vmax:
            self.vmax = v

    def record_many(self, values: Iterable[float]) -> None:
        for v in values:
            self.record(v)

    def percentile(self, q: float) -> float:
        """Upper bound of the bucket containing the nearest-rank sample
        (the overflow bucket reports the observed max)."""
        if self.count == 0:
            return 0.0
        rank = max(1, math.ceil(q / 100.0 * self.count))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                return self.bounds[i] if i < len(self.bounds) else self.vmax
        return self.vmax

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def snapshot(self) -> dict:
        return {"count": self.count, "mean": self.mean, "max": self.vmax,
                "p50": self.percentile(50.0), "p99": self.percentile(99.0),
                "p999": self.percentile(99.9)}


class MetricsRegistry:
    """Typed metrics registered by constant name.  Re-registering a name
    returns the existing instrument; registering it as a different type
    is an error (one name, one meaning)."""

    def __init__(self):
        self._metrics: dict[str, Any] = {}

    def _get(self, name: str, cls, *args):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, *args)
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  bounds: Optional[Sequence[float]] = None) -> Histogram:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = Histogram(name, bounds)
        elif not isinstance(m, Histogram):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, not Histogram")
        return m

    def snapshot(self) -> dict:
        """One dict per bench phase: counters/gauges flatten to values,
        histograms to their percentile snapshots."""
        out = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            out[name] = m.snapshot() if isinstance(m, Histogram) else m.value
        return out

    def reset(self) -> None:
        self._metrics.clear()


# ---------------------------------------------------------------------------
# Prefetch attribution
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PrefetchCause:
    """Why a background fetch was issued: the probabilistic tree (named
    by its root container key), the pattern length (depth of the
    predicted node — the length of the confirmed prefix that predicted
    it), the heuristic, and the node's cumulative confidence."""

    root: Any              # the tree's root container key (or item id)
    length: int            # predicted node depth == pattern prefix length
    heuristic: str
    confidence: float = 0.0

    def group_key(self) -> tuple:
        """Aggregation key: confidence is a per-fetch sample, not part
        of the pattern's identity."""
        return (self.heuristic, self.root, self.length)


_UNATTRIBUTED = ("unattributed", None, 0)


@dataclasses.dataclass
class AttributionRow:
    prefetched: int = 0          # admitted background fetches
    hits: int = 0                # first-touch prefetch hits
    unused: int = 0              # evicted/invalidated/raced, never touched
    bytes_prefetched: int = 0
    bytes_hit: int = 0
    bytes_unused: int = 0
    confidence_sum: float = 0.0  # over prefetched (mean = sum/prefetched)


class AttributionTable:
    """Per-pattern prefetch accounting, fed by the two-space cache.

    Conservation: every admitted prefetch is either eventually *hit*
    (first touch), recorded *unused* on its way out (evicted from the
    preemptive space, invalidated, or raced by a demand fetch), or
    still resident.  Summing ``hits`` over rows equals the cache's
    ``prefetch_hits`` counter exactly — the tier-1 test pins this.
    """

    __slots__ = ("rows",)

    def __init__(self):
        self.rows: dict[tuple, AttributionRow] = {}

    def _row(self, cause: Optional[PrefetchCause]) -> AttributionRow:
        key = cause.group_key() if cause is not None else _UNATTRIBUTED
        row = self.rows.get(key)
        if row is None:
            row = self.rows[key] = AttributionRow()
        return row

    def record_prefetch(self, cause: Optional[PrefetchCause],
                        size: int) -> None:
        row = self._row(cause)
        row.prefetched += 1
        row.bytes_prefetched += int(size)
        if cause is not None:
            row.confidence_sum += cause.confidence

    def record_hit(self, cause: Optional[PrefetchCause], size: int) -> None:
        row = self._row(cause)
        row.hits += 1
        row.bytes_hit += int(size)

    def record_unused(self, cause: Optional[PrefetchCause],
                      size: int) -> None:
        row = self._row(cause)
        row.unused += 1
        row.bytes_unused += int(size)

    # -- aggregation -----------------------------------------------------
    def merge(self, other: "AttributionTable") -> "AttributionTable":
        for key, r in other.rows.items():
            mine = self.rows.get(key)
            if mine is None:
                mine = self.rows[key] = AttributionRow()
            for f in dataclasses.fields(AttributionRow):
                setattr(mine, f.name,
                        getattr(mine, f.name) + getattr(r, f.name))
        return self

    @staticmethod
    def merged(tables: Iterable["AttributionTable"]) -> "AttributionTable":
        out = AttributionTable()
        for t in tables:
            out.merge(t)
        return out

    # -- roll-ups --------------------------------------------------------
    @property
    def total_hits(self) -> int:
        return sum(r.hits for r in self.rows.values())

    @property
    def total_prefetched(self) -> int:
        return sum(r.prefetched for r in self.rows.values())

    @property
    def waste_ratio(self) -> float:
        """Unused mass over prefetched mass (bytes) — the efficiency
        complement of precision, by pattern-attributable bytes."""
        pre = sum(r.bytes_prefetched for r in self.rows.values())
        return (sum(r.bytes_unused for r in self.rows.values()) / pre
                if pre else 0.0)

    def hit_mass_by_length_decile(self, max_len: int = 15) -> list[float]:
        """Hit byte-mass bucketed into 10 pattern-length deciles of
        ``[1, max_len]`` — MITHRIL's question ("which signal source
        earns its prefetches?") asked of pattern length."""
        out = [0.0] * 10
        for (_h, _root, length), r in self.rows.items():
            d = min(9, max(0, (max(1, int(length)) - 1) * 10 // max_len))
            out[d] += r.bytes_hit
        return out

    def top_rows(self, n: int = 5) -> list[dict]:
        """The n patterns with the most hit mass (ties: most prefetched),
        as plain dicts for JSON export / step summaries."""
        keyed = sorted(
            self.rows.items(),
            key=lambda kv: (-kv[1].bytes_hit, -kv[1].prefetched,
                            repr(kv[0])))
        out = []
        for (heur, root, length), r in keyed[:n]:
            out.append({
                "heuristic": heur, "root": _jsonable(root),
                "length": length, "prefetched": r.prefetched,
                "hits": r.hits, "unused": r.unused,
                "bytes_hit": r.bytes_hit,
                "mean_confidence": (r.confidence_sum / r.prefetched
                                    if r.prefetched else 0.0),
            })
        return out
