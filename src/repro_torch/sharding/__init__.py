"""Sharding: logical axes -> mesh axes with divisibility fallback
(``rules``), parameters placed as DTensors on a ``DeviceMesh``
(``place``), and the ``model`` axis's tensor and sequence parallelism
(``tp``).  The port of ``src/repro/sharding``."""
from . import place, rules, tp
from .rules import (
    batch_specs_pspec, cache_pspec, fallback_report, opt_pspec,
    param_specs, placements,
)

__all__ = [
    "batch_specs_pspec", "cache_pspec", "fallback_report", "opt_pspec",
    "param_specs", "place", "placements", "rules", "tp",
]
