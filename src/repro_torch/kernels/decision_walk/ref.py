"""Numpy reference of the decision walk.

Copied from ``src/repro/kernels/decision_walk/ref.py``, over the port's
own :func:`repro_torch.core.decision.advance_step` and ``wave_select``:
the core engine's pure step functions, shaped to the ops-level contract
so the parity tests compare like with like.
"""

from __future__ import annotations

import numpy as np

from ...core.decision import advance_step, wave_select

__all__ = ["decision_walk_ref"]


def decision_walk_ref(flat, nodes, trees, fetched, item: int,
                      p_depth: int) -> dict:
    """Same output dict as ``ops.decision_walk`` (numpy, no torch)."""
    nodes = np.asarray(nodes, np.int64)
    trees = np.asarray(trees, np.int64)
    fetched = np.asarray(fetched, np.int64)
    st = advance_step(flat, nodes, trees, fetched, item, p_depth)
    em = np.flatnonzero(st["emit"])
    wave_nodes = np.empty(0, np.int64)
    if len(em):
        wave_nodes, _ = wave_select(flat, st["nodes"][em], trees[em],
                                    st["lo"][em], st["hi"][em])
    return {
        "found": st["found"], "stay": st["stay"], "nodes": st["nodes"],
        "alive": st["alive"], "fetched": st["fetched"],
        "wave_nodes": wave_nodes,
    }
