"""PALPATINE core on PyTorch: the single client's main path.

The counterpart of ``src/repro/core``: frequent-sequence mining with the
bitmaps on the device, probabilistic trees, prefetching heuristics (the
decision engine's ``backend="torch"`` walks on the device), the two-space
cache, the simulated back store, and the sharded cluster (membership,
chaos and versioned replicas) whose tenants mine on the device.
"""

from .api import Client
from .backstore import Channel, Clock, LatencyModel, RPCFuture, SimulatedDKVStore
from .cache import CacheStats, TwoSpaceCache
from .chaos import ChaosEngine, ChaosSchedule, Fault
from .cluster import (
    ClusterBaseline,
    ClusterClient,
    ClusterConfig,
    PatternExchange,
    ShardedDKVStore,
    ShardedTwoSpaceCache,
    VerdictExchange,
)
from .decision import VectorizedPrefetchEngine, build_engine
from .heuristics import HEURISTICS, HeuristicConfig, PrefetchEngine
from .membership import (
    BudgetRebalancer,
    FailureDetector,
    HintedHandoffLog,
    LeaseConflict,
    LeaseTable,
    MembershipEvent,
    MoveReport,
    RangeLease,
)
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
from .versions import DottedVersion, concurrent, descends, merge
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
    "BaselineClient", "BudgetRebalancer", "CacheStats", "Channel",
    "ChaosEngine", "ChaosSchedule", "Client", "Clock", "ClusterBaseline",
    "ClusterClient", "ClusterConfig", "Container", "DottedVersion",
    "FailureDetector", "Fault", "FlatForest", "HEURISTICS",
    "HeuristicConfig", "HintedHandoffLog", "Histogram", "LatencyModel",
    "LeaseConflict", "LeaseTable", "MembershipEvent", "MetricsRegistry",
    "MiningParams", "MoveReport", "NULL_TRACER", "NullTracer",
    "PalpatineClient", "PalpatineConfig", "Pattern", "PatternExchange",
    "PatternMetastore", "PrefetchCause", "PrefetchEngine", "PTree",
    "PTreeIndex", "RangeLease", "RPCFuture", "SequenceDatabase",
    "ShardedDKVStore", "ShardedTwoSpaceCache", "SimulatedDKVStore", "Span",
    "Tracer", "TwoSpaceCache", "VectorizedPrefetchEngine", "VerdictBoard",
    "VerdictExchange", "VerticalBitmaps", "bitmaps_from_numpy",
    "brute_force", "build_engine", "concurrent", "critical_path",
    "descends", "dynamic_floor_count", "latency_percentiles", "merge",
    "mine", "mine_dynamic_minsup", "percentile", "span_kind_breakdown",
]
