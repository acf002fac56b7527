"""Public wrappers of the decision walk.

The port's counterpart of ``src/repro/kernels/decision_walk/ops.py``.
:func:`device_forest` holds one mining generation's :class:`FlatForest`
on the device (an empty edge table gets an unmatchable sentinel, so
``searchsorted`` stays shape-safe); :func:`decision_walk` pads the live
context state to the engine's ``max_contexts``, runs
:func:`.decision_walk.decision_walk_step` there and returns the compact
numpy state dict the core engine consumes.  ``interpret=True`` routes to
the numpy reference (:mod:`.ref`), as the reference's escape hatch does.

The step is torch operations, not a hand-written kernel: the reference's
twin is a ``jax.jit`` program, not a Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ...device import resolve_device
from . import ref as _ref
from .decision_walk import decision_walk_step, top_k_frontier

__all__ = ["DeviceForest", "device_forest", "decision_walk",
           "top_k_frontier"]

_SENTINEL = np.iinfo(np.int64).max


class DeviceForest:
    """One generation's FlatForest arrays on ``device`` (int64)."""

    def __init__(self, flat, device=None):
        self.device = resolve_device(device)
        ek = flat.edge_keys
        ec = flat.edge_child
        if ek.size == 0:
            ek = np.array([_SENTINEL], np.int64)
            ec = np.zeros(1, np.int64)

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

        self.edge_keys = dev(ek)
        self.edge_child = dev(ec)
        self.items = dev(flat.items)
        self.depth = dev(flat.depth)
        self.pre = dev(flat.pre)
        self.post = dev(flat.post)
        self.n_children = dev(flat.n_children)
        self.tree_start = dev(flat.tree_start)
        self.tree_max_depth = dev(flat.tree_max_depth)
        self.level_key = dev(flat.level_key)


def device_forest(flat, device=None) -> DeviceForest:
    return DeviceForest(flat, device)


def decision_walk(jf: DeviceForest, flat, nodes, trees, fetched,
                  item: int, p_depth: int,
                  max_contexts: int | None = None,
                  interpret: bool | None = None) -> dict:
    """Advance the ``n`` live contexts by ``item`` on ``jf``'s device.

    Returns the same state dict as :func:`repro_torch.core.decision.
    advance_step`, plus the selected ``wave_nodes`` (row-major nonzeros of
    the dense wave mask: the scalar engine's context-major, level-ordered
    emission), all numpy.  ``interpret=True`` runs the numpy reference
    (:func:`.ref.decision_walk_ref`) instead."""
    if interpret:
        return _ref.decision_walk_ref(flat, nodes, trees, fetched,
                                      item, p_depth)
    n = len(nodes)
    if flat.n_nodes == 0:
        # zero-node forest: nothing to gather against, and every context
        # is dead by construction (none could have been opened)
        z = np.zeros(n, np.int64)
        f = np.zeros(n, bool)
        return {"found": f, "stay": f.copy(), "nodes": z,
                "alive": f.copy(), "fetched": z.copy(),
                "wave_nodes": np.empty(0, np.int64)}
    c = max_contexts or max(n, 1)
    # one host-to-device copy of the padded (nodes, trees, fetched, alive)
    state = np.zeros((4, c), np.int64)
    state[0, :n] = nodes
    state[1, :n] = trees
    state[2, :n] = fetched
    state[3, :n] = 1
    st = torch.as_tensor(state, device=jf.device)
    out = decision_walk_step(
        jf.edge_keys, jf.edge_child, jf.items, jf.depth, jf.pre, jf.post,
        jf.n_children, jf.tree_start, jf.tree_max_depth, jf.level_key,
        st[0], st[1], st[2], st[3] != 0, item, p_depth=p_depth,
        item_stride=flat.item_stride, depth_stride=flat.depth_stride)
    new_nodes, new_fetched, new_alive, found, stay, mask = out
    # one device-to-host copy of the state, one of the wave
    back = torch.stack([new_nodes[:n], new_fetched[:n], new_alive[:n].long(),
                        found[:n].long(), stay[:n].long()]).cpu().numpy()
    wave_nodes = torch.nonzero(mask[:n])[:, 1].cpu().numpy()
    return {
        "found": back[3].astype(bool), "stay": back[4].astype(bool),
        "nodes": back[0], "alive": back[2].astype(bool),
        "fetched": back[1], "wave_nodes": wave_nodes.astype(np.int64),
    }
