"""Prefetching heuristics (Palpatine §4.3) — scalar reference engine.

Copied unchanged from ``src/repro/core/heuristics.py``: the port keeps
its own copy and imports nothing from ``repro``.

Each client read that matches a root node of a stored probabilistic tree
opens a *prefetch context*.  Multiple contexts may be active in parallel.
The three strategies, conservative → progressive:

* ``fetch_all``          — prefetch the entire tree (best accuracy, highest
                           pollution potential).
* ``fetch_top_n``        — prefetch the n nodes with highest *cumulative*
                           probability, level-order first, probability-wise
                           second (default n=5).
* ``fetch_progressive``  — prefetch the next n levels (default n=2); on each
                           subsequent request that continues the matched
                           subsequence without gaps, prefetch the next
                           non-cached level reachable from the confirmed
                           path; abandon on divergence.

Two engines implement the identical decision semantics:

* :class:`PrefetchEngine` (this module) — the scalar oracle: one Python
  tree walk per live context per request, over ``PNode`` dicts.  Simple,
  and the ground truth the differential suite pins the fast path against
  (the same role ``_dfs_mine`` plays for the frontier miner).
* :class:`repro.core.decision.VectorizedPrefetchEngine` — the hot path:
  every generation of trees is flattened once into CSR-style arrays
  (:class:`repro.core.ptree.FlatForest`: per-node item/depth/``prob``/
  ``cum_prob``, contiguous child ranges, DFS preorder intervals, a sorted
  edge-key table), and one request advances *all* live contexts with a
  single batched array program — an edge-table ``searchsorted`` for the
  walk, per-tree depth-band slicing plus preorder-interval masks for the
  waves, and precomputed top-k frontier selections for the initial waves.
  Per-op decision cost stays ~flat as live contexts multiply, which is
  what keeps the prefetching calculus intact once decision cost rivals
  the access latency it hides.

Context management (both engines, bug-for-bug identical):

* a request that re-confirms a root an open context is already sitting on
  neither kills the context nor opens a duplicate — contexts are deduped
  by (tree, confirmed node) at open;
* when the context list is saturated a new root match evicts the stalest
  (least-recently-advanced) context instead of being dropped, so
  progressive follow-up waves keep flowing under churn;
* depth-0 trees are never built (``PTreeIndex.build`` skips length-1
  patterns) and ``initial()`` refuses them, so do-nothing contexts are
  never created.
"""

from __future__ import annotations

import dataclasses

from .obs import PrefetchCause
from .ptree import PNode, PTree, PTreeIndex

__all__ = ["HeuristicConfig", "PrefetchContext", "PrefetchEngine", "HEURISTICS"]

HEURISTICS = ("fetch_all", "fetch_top_n", "fetch_progressive")


@dataclasses.dataclass(frozen=True)
class HeuristicConfig:
    name: str = "fetch_progressive"
    top_n: int = 5               # fetch_top_n
    progressive_depth: int = 2   # fetch_progressive levels-ahead

    def __post_init__(self):
        if self.name not in HEURISTICS:
            raise ValueError(f"unknown heuristic {self.name!r}")


class PrefetchContext:
    """Per-root-match state machine.  ``initial()`` yields the first wave of
    nodes to prefetch; ``on_request(item)`` advances the context and yields
    follow-up waves (only fetch_progressive is multi-wave)."""

    def __init__(self, tree: PTree, cfg: HeuristicConfig):
        self.tree = tree
        self.cfg = cfg
        self.node = tree.root          # confirmed position (progressive)
        self.fetched_depth = 0         # deepest level already requested
        self.alive = True
        self.stamp = 0                 # engine op of the last confirmation

    def initial(self) -> list[PNode]:
        name = self.cfg.name
        if name == "fetch_all":
            self.alive = False
            return list(self.tree.nodes_below())
        if name == "fetch_top_n":
            self.alive = False
            return self.tree.top_n_cumulative(self.cfg.top_n)
        if self.tree.max_depth == 0:
            # a depth-0 tree has nothing to prefetch and nowhere to
            # advance: refuse to open a do-nothing context
            self.alive = False
            return []
        # fetch_progressive: next n levels from the root
        self.fetched_depth = min(self.cfg.progressive_depth, self.tree.max_depth)
        return self.tree.levels(1, self.fetched_depth)

    def on_request(self, item: int, op: int = 0) -> list[PNode]:
        """Progressive only: confirm the path or die."""
        if not self.alive:
            return []
        child = self.node.children.get(item)
        if child is None:
            if self.node is self.tree.root and self.node.item == item:
                # the root re-confirmed itself: the context stays put
                # (its waves are already in flight) instead of dying and
                # being reopened with the same waves recomputed
                self.stamp = op
                return []
            self.alive = False  # request diverged from the frequent sequence
            return []
        self.node = child
        self.stamp = op
        if self.node.depth >= self.tree.max_depth or not self.node.children:
            self.alive = False
        # cut the tree along the confirmed path: fetch the next non-cached
        # level reachable from the confirmed node
        target = self.node.depth + self.cfg.progressive_depth
        if target <= self.fetched_depth:
            return []
        lo = self.fetched_depth + 1
        self.fetched_depth = target
        return _subtree_levels(self.node, lo, target)


def _subtree_levels(node: PNode, lo: int, hi: int) -> list[PNode]:
    """Nodes in ``node``'s subtree with absolute depth in [lo, hi]."""
    out: list[PNode] = []
    for nd in node.level_order():
        if nd.depth > hi:
            break
        if nd.depth >= lo:
            out.append(nd)
    return out


class PrefetchEngine:
    """Matches requests against the root index, manages live contexts, and
    emits the list of items to prefetch for each request (paper §4.1 steps
    g/h/i)."""

    def __init__(self, index: PTreeIndex, cfg: HeuristicConfig,
                 max_contexts: int = 256):
        self.index = index
        self.cfg = cfg
        self.max_contexts = max_contexts
        self.contexts: list[PrefetchContext] = []
        self._op = 0
        # Palpascope attribution (same surface as the vectorized twin)
        self.attribute = False
        self._last_causes: list[PrefetchCause] = []

    @property
    def n_live(self) -> int:
        return len(self.contexts)

    def replace_index(self, index: PTreeIndex) -> None:
        """Fresh mining generation: drop stale contexts (their trees are
        obsolete)."""
        self.index = index
        self.contexts = []

    def on_request(self, item: int) -> list[int]:
        """Returns item ids to prefetch (deduplicated, wave order kept)."""
        self._op += 1
        wave: list[PNode] = []
        src: list[PTree] = []    # parallel owner trees (attribution only)
        # 1. advance live contexts along the confirmed subsequences
        live: list[PrefetchContext] = []
        for ctx in self.contexts:
            w = ctx.on_request(item, self._op)
            wave.extend(w)
            if self.attribute and w:
                src.extend([ctx.tree] * len(w))
            if ctx.alive:
                live.append(ctx)
        self.contexts = live
        # 2. a request matching a root opens a new context — unless a live
        #    context already sits at that exact (tree, confirmed node)
        tree = self.index.match_root(item)
        if tree is not None:
            dup = next((c for c in self.contexts
                        if c.tree is tree and c.node is tree.root), None)
            if dup is not None:
                dup.stamp = self._op   # refreshed, not duplicated
            else:
                ctx = PrefetchContext(tree, self.cfg)
                ctx.stamp = self._op
                w = ctx.initial()
                wave.extend(w)
                if self.attribute and w:
                    src.extend([tree] * len(w))
                if ctx.alive:
                    if len(self.contexts) >= self.max_contexts:
                        # saturated: evict the stalest context (least
                        # recently confirmed; ties fall to the oldest)
                        # rather than silently dropping the new one
                        ev = min(range(len(self.contexts)),
                                 key=lambda i: self.contexts[i].stamp)
                        self.contexts.pop(ev)
                    self.contexts.append(ctx)
        seen: set = set()
        out: list[int] = []
        causes: list[PrefetchCause] = []
        for i, nd in enumerate(wave):
            if nd.item not in seen:
                seen.add(nd.item)
                out.append(nd.item)
                if self.attribute:
                    tr = src[i]
                    causes.append(PrefetchCause(
                        tr.root.item, nd.depth, self.cfg.name, nd.cum_prob))
        self._last_causes = causes
        return out

    def last_attribution(self) -> list[PrefetchCause]:
        """One :class:`PrefetchCause` per item of the last ``on_request``
        return (same order).  Empty unless ``attribute`` is enabled."""
        return self._last_causes
