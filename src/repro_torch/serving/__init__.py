"""Serving on PyTorch: the batched prefill/decode engine.

The port of ``src/repro/serving`` holds the engine only; the expert
prefetcher and the load generator are not ported yet (ROADMAP Queue 1
item 6).
"""

from .engine import ServeConfig, ServingEngine

__all__ = ["ServeConfig", "ServingEngine"]
