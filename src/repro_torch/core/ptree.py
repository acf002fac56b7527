"""Probabilistic trees (Palpatine §4.2, Figure 3).

Copied unchanged from ``src/repro/core/ptree.py``: the port keeps its
own copy and imports nothing from ``repro``.

The metastore's frequent sequences are compiled into a forest of
probabilistic trees (akin to Markov chains): node = accessed item, edge =
transition with a probability estimated from observed sequence frequencies.
One tree per distinct first item; roots are indexed by item so a client
request can be matched in O(1).

Node probabilities:
  * ``prob``     — conditional: P(child | parent reached), normalized over
                   siblings by pattern support mass.
  * ``cum_prob`` — cumulative from the root: probability the item is
                   requested when starting from the root (used by the
                   fetch-top-n heuristic, level-order + probability-wise).

``PTreeIndex.flatten`` compiles a finished generation of trees into a
:class:`FlatForest` — one CSR-style array bundle over the whole forest —
so the vectorized decision engine (:mod:`repro.core.decision`) can walk
every live prefetch context in a single array program instead of one
Python pointer chase per context.
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import deque
from typing import Iterable, Iterator, Optional

import numpy as np

from .mining import Pattern

__all__ = ["PNode", "PTree", "PTreeIndex", "FlatForest"]


class PNode:
    __slots__ = ("item", "weight", "prob", "cum_prob", "depth", "children", "parent")

    def __init__(self, item: int, depth: int, parent: Optional["PNode"]):
        self.item = item
        self.weight = 0.0      # support mass flowing through this node
        self.prob = 1.0        # P(this | parent)
        self.cum_prob = 1.0    # P(this | root)
        self.depth = depth
        self.children: dict[int, PNode] = {}
        self.parent = parent

    def level_order(self) -> Iterator["PNode"]:
        queue = deque((self,))
        while queue:
            node = queue.popleft()
            yield node
            queue.extend(node.children.values())

    def __repr__(self) -> str:
        return f"PNode({self.item}, p={self.prob:.2f}, cp={self.cum_prob:.2f})"


class PTree:
    """A tree rooted at one first-item; paths are mined frequent sequences."""

    def __init__(self, root_item: int):
        self.root = PNode(root_item, depth=0, parent=None)
        self.max_depth = 0

    def insert(self, items: tuple, support: int) -> None:
        assert items[0] == self.root.item
        node = self.root
        node.weight += support
        for it in items[1:]:
            child = node.children.get(it)
            if child is None:
                child = PNode(it, node.depth + 1, node)
                node.children[it] = child
            child.weight += support
            node = child
        self.max_depth = max(self.max_depth, len(items) - 1)

    def finalize(self) -> None:
        """Normalize sibling weights into conditional + cumulative probs."""
        for node in self.root.level_order():
            total = sum(c.weight for c in node.children.values())
            for c in node.children.values():
                c.prob = (c.weight / total) if total > 0 else 0.0
                c.cum_prob = node.cum_prob * c.prob

    # -- queries used by the heuristics --------------------------------
    def nodes_below(self) -> Iterator[PNode]:
        """All non-root nodes, level order."""
        it = self.root.level_order()
        next(it)  # skip root
        return it

    def top_n_cumulative(self, n: int) -> list[PNode]:
        """The n non-root nodes with highest cumulative probability,
        returned level-order first, probability-wise second (paper §4.5)."""
        best = heapq.nlargest(
            n, self.nodes_below(), key=lambda nd: (nd.cum_prob, -nd.depth)
        )
        return sorted(best, key=lambda nd: (nd.depth, -nd.cum_prob))

    def levels(self, lo: int, hi: int) -> list[PNode]:
        """Nodes with lo <= depth <= hi, level order."""
        return [nd for nd in self.nodes_below() if lo <= nd.depth <= hi]

    def walk(self, path: tuple) -> Optional[PNode]:
        """Follow ``path`` (item ids, starting at the root item) down the
        tree; None if it diverges."""
        if not path or path[0] != self.root.item:
            return None
        node = self.root
        for it in path[1:]:
            node = node.children.get(it)
            if node is None:
                return None
        return node

    def size(self) -> int:
        return sum(1 for _ in self.root.level_order())


@dataclasses.dataclass(frozen=True)
class FlatForest:
    """A finished tree generation flattened into CSR-style arrays.

    Node ids are assigned per tree in level (BFS) order, trees
    concatenated, which buys three invariants the vectorized walk relies
    on:

    * tree ``t`` owns the id range ``[tree_start[t], tree_start[t+1])``
      and ``tree_start[t]`` is its root;
    * within a tree the ids are level-ordered, so any node subset sorted
      by id is already in the wave order the scalar engine emits;
    * the children of node ``v`` are the contiguous ids
      ``[first_child[v], first_child[v] + n_children[v])``.

    ``pre``/``post`` carry each node's DFS preorder interval (``u`` is in
    ``v``'s subtree iff ``pre[v] <= pre[u] < post[v]``), and ``level_key =
    tree_of * depth_stride + depth`` is globally non-decreasing, so one
    batched ``searchsorted`` finds any per-tree depth band.  Edges are a
    sorted ``parent_id * item_stride + item`` key table: advancing C live
    contexts by the requested item is one ``searchsorted`` over C keys.
    """

    items: np.ndarray         # int64[n]  item id per node
    depth: np.ndarray         # int64[n]
    prob: np.ndarray          # float64[n]  P(node | parent)
    cum_prob: np.ndarray      # float64[n]  P(node | root)
    first_child: np.ndarray   # int64[n]
    n_children: np.ndarray    # int64[n]
    pre: np.ndarray           # int64[n]  DFS preorder rank
    post: np.ndarray          # int64[n]  subtree end (preorder interval)
    tree_of: np.ndarray       # int64[n]
    tree_start: np.ndarray    # int64[T+1]
    tree_max_depth: np.ndarray  # int64[T]
    level_key: np.ndarray     # int64[n]  tree_of * depth_stride + depth
    depth_stride: int
    edge_keys: np.ndarray     # int64[E]  sorted parent * item_stride + item
    edge_child: np.ndarray    # int64[E]
    item_stride: int
    root_tree: dict           # {root item -> tree index}

    @property
    def n_nodes(self) -> int:
        return len(self.items)

    @property
    def n_trees(self) -> int:
        return len(self.tree_max_depth)

    def level_band(self, trees: np.ndarray, lo: np.ndarray,
                   hi: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Batched per-tree depth-band lookup: node-id ranges ``[a, b)``
        covering depths ``[lo, hi]`` of each queried tree."""
        d = self.depth_stride
        a = np.searchsorted(self.level_key, trees * d + lo, side="left")
        b = np.searchsorted(self.level_key, trees * d + hi + 1, side="left")
        return a, b


class PTreeIndex:
    """Hash table of trees keyed by the first item of the frequent sequences
    (paper §4.5: 'hash tables of trees whose keys represent the first items').
    """

    def __init__(self):
        self.trees: dict[int, PTree] = {}

    @classmethod
    def build(cls, patterns: Iterable[Pattern]) -> "PTreeIndex":
        idx = cls()
        for p in patterns:
            if len(p.items) < 2:
                # a length-1 pattern would build a depth-0 tree whose
                # progressive context has an empty initial wave and can
                # never advance — a do-nothing context that only burns a
                # slot for an op; never create the tree at all
                continue
            tree = idx.trees.get(p.items[0])
            if tree is None:
                tree = idx.trees[p.items[0]] = PTree(p.items[0])
            tree.insert(p.items, p.support)
        for tree in idx.trees.values():
            tree.finalize()
        return idx

    def match_root(self, item: int) -> Optional[PTree]:
        return self.trees.get(item)

    def __len__(self) -> int:
        return len(self.trees)

    def flatten(self) -> FlatForest:
        """Compile this generation into the :class:`FlatForest` array
        bundle (done once per ``replace_index``, amortized over every
        subsequent request)."""
        order: list[PNode] = []
        tree_of: list[int] = []
        tree_start = [0]
        tree_maxd: list[int] = []
        root_tree: dict = {}
        for t, (ritem, tree) in enumerate(self.trees.items()):
            root_tree[ritem] = t
            sub = list(tree.root.level_order())
            order.extend(sub)
            tree_of.extend([t] * len(sub))
            tree_start.append(len(order))
            tree_maxd.append(tree.max_depth)
        n = len(order)
        id_of = {id(nd): i for i, nd in enumerate(order)}
        items = np.empty(n, np.int64)
        depth = np.empty(n, np.int64)
        prob = np.empty(n, np.float64)
        cum = np.empty(n, np.float64)
        first_child = np.zeros(n, np.int64)
        n_children = np.zeros(n, np.int64)
        for i, nd in enumerate(order):
            items[i] = nd.item
            depth[i] = nd.depth
            prob[i] = nd.prob
            cum[i] = nd.cum_prob
            if nd.children:
                # BFS hands children consecutive ids in dict order, so
                # the first child in dict order holds the lowest id
                first_child[i] = id_of[id(next(iter(nd.children.values())))]
                n_children[i] = len(nd.children)
        # DFS preorder intervals for O(1) subtree membership
        pre = np.zeros(n, np.int64)
        post = np.zeros(n, np.int64)
        counter = 0
        for t in range(len(tree_maxd)):
            stack = [(tree_start[t], False)]
            while stack:
                v, done = stack.pop()
                if done:
                    post[v] = counter
                    continue
                pre[v] = counter
                counter += 1
                stack.append((v, True))
                fc, k = first_child[v], n_children[v]
                # push in reverse so the first child is visited first
                for c in range(fc + k - 1, fc - 1, -1):
                    stack.append((int(c), False))
        max_depth = int(depth.max()) if n else 0
        depth_stride = max_depth + 2
        tof = np.asarray(tree_of, np.int64)
        level_key = tof * depth_stride + depth
        item_stride = int(items.max()) + 1 if n else 1
        child_ids = np.flatnonzero(depth > 0)
        parents = np.empty(len(child_ids), np.int64)
        for j, c in enumerate(child_ids):
            parents[j] = id_of[id(order[c].parent)]
        ekeys = parents * item_stride + items[child_ids]
        o = np.argsort(ekeys, kind="stable")
        return FlatForest(
            items=items, depth=depth, prob=prob, cum_prob=cum,
            first_child=first_child, n_children=n_children,
            pre=pre, post=post, tree_of=tof,
            tree_start=np.asarray(tree_start, np.int64),
            tree_max_depth=np.asarray(tree_maxd, np.int64),
            level_key=level_key, depth_stride=depth_stride,
            edge_keys=ekeys[o], edge_child=child_ids[o].astype(np.int64),
            item_stride=item_stride, root_tree=root_tree,
        )
