"""PALPATINE core on PyTorch: the single client's main path.

The counterpart of ``src/repro/core``: frequent-sequence mining with the
bitmaps on the device, probabilistic trees, prefetching heuristics, the
two-space cache and the simulated back store.  The sharded cluster,
membership, chaos and versioned replicas are not ported yet.
"""

from .api import Client
from .backstore import Channel, Clock, LatencyModel, RPCFuture, SimulatedDKVStore
from .cache import CacheStats, TwoSpaceCache
from .decision import VectorizedPrefetchEngine, build_engine
from .heuristics import HEURISTICS, HeuristicConfig, PrefetchEngine
from .metastore import PatternMetastore, VerdictBoard
from .obs import (
    NULL_TRACER,
    AttributionTable,
    Histogram,
    MetricsRegistry,
    NullTracer,
    PrefetchCause,
    Span,
    Tracer,
    critical_path,
    latency_percentiles,
    percentile,
    span_kind_breakdown,
)
from .mining import (
    ALGORITHMS,
    BITMAP_ALGOS,
    MiningParams,
    Pattern,
    VerticalBitmaps,
    bitmaps_from_numpy,
    brute_force,
    dynamic_floor_count,
    mine,
    mine_dynamic_minsup,
)
from .palpatine import BaselineClient, PalpatineClient, PalpatineConfig
from .ptree import FlatForest, PTree, PTreeIndex
from .sessions import AccessLogger, Container, SequenceDatabase

__all__ = [
    "AccessLogger", "ALGORITHMS", "AttributionTable", "BITMAP_ALGOS",
    "BaselineClient", "CacheStats", "Channel", "Client", "Clock",
    "Container", "FlatForest", "HEURISTICS", "HeuristicConfig",
    "Histogram", "LatencyModel", "MetricsRegistry", "MiningParams",
    "NULL_TRACER", "NullTracer", "PalpatineClient", "PalpatineConfig",
    "Pattern", "PatternMetastore", "PrefetchCause", "PrefetchEngine",
    "PTree", "PTreeIndex", "RPCFuture", "SequenceDatabase",
    "SimulatedDKVStore", "Span", "Tracer", "TwoSpaceCache",
    "VectorizedPrefetchEngine", "VerdictBoard", "VerticalBitmaps",
    "bitmaps_from_numpy", "brute_force", "build_engine", "critical_path",
    "dynamic_floor_count", "latency_percentiles", "mine",
    "mine_dynamic_minsup", "percentile", "span_kind_breakdown",
]
