"""The prefetch-decision walk as torch operations (the device twin of
:mod:`repro_torch.core.decision`).

The port of ``src/repro/kernels/decision_walk/decision_walk.py``, whose
two functions are ``jax.jit`` programs, not Pallas kernels; here they are
plain torch operations on int64 tensors, on whatever device those lie.
One step advances every live prefetch context by the requested item, a
probability-matrix walk over the flattened pattern forest:

* the edge table (sorted ``parent * item_stride + item`` keys) resolves
  all C confirmed positions with one ``torch.searchsorted`` (left side,
  as ``jnp.searchsorted``);
* wave selection broadcasts each emitting context's depth band and DFS
  preorder interval against the whole node table, giving a dense (C, N)
  wave mask whose row-major nonzeros are exactly the scalar engine's
  (context order, level order) emission;
* :func:`top_k_frontier` is the top-k frontier selection of
  ``fetch_top_n`` initial waves: a stable lexicographic (cum_prob desc,
  depth asc, level-order asc) pick, re-emitted (depth asc, cum desc).

The reference's step also carries per-context stamps, which no caller
reads; the port leaves them out.  JAX clamps an out-of-range gather
where torch raises (CPU) or asserts (card).  Every gather here is in range for a valid state: the edge
position is clamped as in the reference, and nodes, children and trees
index their own tables (padding rows hold node 0 and tree 0, which
exist whenever the forest has a node).
"""

from __future__ import annotations

import torch

__all__ = ["decision_walk_step", "top_k_frontier"]


def decision_walk_step(edge_keys, edge_child, items, depth, pre, post,
                       n_children, tree_start, tree_max_depth, level_key,
                       nodes, trees, fetched, alive, item: int, *,
                       p_depth: int, item_stride: int, depth_stride: int):
    """Advance C (padded) contexts by ``item``; returns the new context
    state plus the dense (C, N) wave mask.

    Dead and padding rows carry ``alive=False`` and never match, emit or
    resurrect: zero padding is decision-neutral."""
    keys = nodes * item_stride + item
    pos = torch.searchsorted(edge_keys, keys)
    posc = pos.clamp(0, edge_keys.shape[0] - 1)
    in_vocab = 0 <= item < item_stride
    found = alive & in_vocab & (edge_keys[posc] == keys)
    child = edge_child[posc]
    roots = tree_start[trees]
    stay = (alive & in_vocab & ~found & (nodes == roots)
            & (items[nodes] == item))
    new_nodes = torch.where(found, child, nodes)
    cdepth = depth[new_nodes]
    target = cdepth + p_depth
    emit = found & (target > fetched)
    dies_after = found & ((cdepth >= tree_max_depth[trees])
                          | (n_children[new_nodes] == 0))
    new_alive = (found & ~dies_after) | stay
    new_fetched = torch.where(emit, target, fetched)
    lo = (trees * depth_stride + fetched + 1)[:, None]
    hi = (trees * depth_stride + target)[:, None]
    band = (level_key[None, :] >= lo) & (level_key[None, :] <= hi)
    sub = ((pre[None, :] >= pre[new_nodes][:, None])
           & (pre[None, :] < post[new_nodes][:, None]))
    wave_mask = band & sub & emit[:, None]
    return new_nodes, new_fetched, new_alive, found, stay, wave_mask


def top_k_frontier(cum_prob: torch.Tensor, depth: torch.Tensor, *,
                   k: int) -> torch.Tensor:
    """Top-k frontier of one tree's non-root slice: select by (cum_prob
    desc, depth asc, level-order asc), emit by (depth asc, cum_prob desc,
    selection order), both stable: the oracle's ``heapq.nlargest`` plus
    stable sort.  torch has no ``lexsort``, so each is a chain of stable
    sorts, the least significant key first."""
    order = torch.arange(cum_prob.shape[0], device=cum_prob.device)
    for key in (depth, -cum_prob):            # ids are already ascending
        order = order[torch.sort(key[order], stable=True).indices]
    sel = order[:k]
    fin = torch.arange(sel.shape[0], device=sel.device)
    for key in (-cum_prob[sel], depth[sel]):
        fin = fin[torch.sort(key[fin], stable=True).indices]
    return sel[fin]
