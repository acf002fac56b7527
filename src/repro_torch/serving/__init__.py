"""Serving on PyTorch: the batched prefill/decode engine, plus PALPATINE's
predictive expert prefetcher over the cluster and its load generator.

The port of ``src/repro/serving``.  The load generator is host-only
simulation; the prefetcher's client mines on the device, and its
``ExpertStore`` decodes weights to device tensors.
"""

from .engine import ServeConfig, ServingEngine
from .loadgen import KV, SHAPES, LoadgenConfig, LoadGenerator
from .prefetcher import ExpertPrefetcher, ExpertStore, PrefetcherConfig

__all__ = ["ExpertPrefetcher", "ExpertStore", "PrefetcherConfig",
           "KV", "SHAPES", "LoadgenConfig", "LoadGenerator",
           "ServeConfig", "ServingEngine"]
