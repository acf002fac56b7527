"""Sharding: logical axes -> mesh axes with divisibility fallback
(``rules``), and parameters placed as DTensors on a ``DeviceMesh``
(``place``).  The port of ``src/repro/sharding``."""
from . import place, rules
from .rules import (
    batch_specs_pspec, cache_pspec, fallback_report, opt_pspec,
    param_specs, placements,
)

__all__ = [
    "batch_specs_pspec", "cache_pspec", "fallback_report", "opt_pspec",
    "param_specs", "place", "placements", "rules",
]
