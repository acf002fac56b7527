"""Vectorized prefetch-decision engine (the per-request hot path).

The scalar :class:`repro.core.heuristics.PrefetchEngine` walks one
``PNode`` dict per live context per request — decision cost grows
linearly with live contexts, exactly the overhead ROADMAP open item 2
says must stay flat as clients multiply.  This module re-implements the
identical decision semantics as a batched array program over the
:class:`repro.core.ptree.FlatForest` CSR bundle that ``replace_index``
compiles once per mining generation:

* **advance**: all C live contexts step by the requested item with one
  ``searchsorted`` into the sorted edge-key table
  (``parent_id * item_stride + item``) — no per-context pointer chase;
* **waves**: each advancing context's next progressive levels are the
  intersection of a per-tree depth band (one batched ``searchsorted``
  over the globally sorted ``level_key``) with the confirmed node's DFS
  preorder interval — emitted in the exact (context order, level order)
  the scalar engine produces;
* **initial waves**: per-tree ``fetch_all`` / top-k frontier
  (``fetch_top_n``) / progressive-prefix selections are precomputed at
  flatten time, so opening a context is an O(1) slice.

Context management (stalest eviction at saturation, (tree, confirmed
node) dedupe at open, depth-0 refusal) is bug-for-bug identical to the
scalar oracle; ``tests/test_decision.py`` pins the two engines
differentially across the heuristic × workload grid.

``backend="torch"`` routes the advance + wave selection through the
device twin in :mod:`repro_torch.kernels.decision_walk` on ``device``
(default the card); the numpy path is the default, as in the reference,
and the one the clients use.

Copied from ``src/repro/core/decision.py``; its ``backend="jax"`` is the
port's ``backend="torch"``, with a ``device``.
"""

from __future__ import annotations

import numpy as np

from ..device import resolve_device
from .heuristics import HeuristicConfig, PrefetchEngine
from .obs import PrefetchCause
from .ptree import FlatForest, PTreeIndex

__all__ = ["VectorizedPrefetchEngine", "build_engine", "advance_step",
           "wave_select"]


def _ranges_concat(a: np.ndarray, b: np.ndarray) -> tuple[np.ndarray,
                                                          np.ndarray]:
    """Flatten ragged index ranges ``[a_i, b_i)`` into one array (range
    order preserved, ascending within each range) + per-range counts."""
    cnt = b - a
    total = int(cnt.sum())
    if total == 0:
        return np.empty(0, np.int64), cnt
    stops = np.cumsum(cnt)
    off = np.arange(total, dtype=np.int64) - np.repeat(stops - cnt, cnt)
    return np.repeat(a, cnt) + off, cnt


def advance_step(flat: FlatForest, nodes: np.ndarray, trees: np.ndarray,
                 fetched: np.ndarray, item: int, p_depth: int) -> dict:
    """One batched context-advancement step (pure, shared with the kernel
    reference).  Mirrors ``PrefetchContext.on_request`` for every live
    context at once; wave emission is separate (:func:`wave_select`)."""
    n = len(nodes)
    if flat.edge_keys.size and 0 <= item < flat.item_stride:
        keys = nodes * flat.item_stride + item
        pos = np.searchsorted(flat.edge_keys, keys)
        posc = np.minimum(pos, len(flat.edge_keys) - 1)
        found = flat.edge_keys[posc] == keys
        child = flat.edge_child[posc]
    else:
        found = np.zeros(n, bool)
        child = nodes
    roots = flat.tree_start[trees]
    in_vocab = 0 <= item < flat.item_stride
    stay = (~found & (nodes == roots) & in_vocab
            & (flat.items[nodes] == item) if n else found)
    new_nodes = np.where(found, child, nodes)
    cdepth = flat.depth[new_nodes]
    target = cdepth + p_depth
    emit = found & (target > fetched)
    # advancing onto a leaf (or the tree's max depth) still emits its
    # final wave; the context is reaped afterwards — same as the oracle
    dies_after = found & ((cdepth >= flat.tree_max_depth[trees])
                          | (flat.n_children[new_nodes] == 0))
    return {
        "found": found, "stay": stay, "nodes": new_nodes,
        "alive": (found & ~dies_after) | stay,
        "emit": emit, "lo": fetched + 1, "hi": target,
        "fetched": np.where(emit, target, fetched),
    }


def wave_select(flat: FlatForest, nodes: np.ndarray, trees: np.ndarray,
                lo: np.ndarray, hi: np.ndarray) -> tuple[np.ndarray,
                                                         np.ndarray]:
    """Wave node ids for emitting contexts: per-tree depth band ∩ DFS
    preorder interval of each confirmed node.  Returns (node ids, owner
    rank) in (context order, level order) — node-id order inside one
    tree slice *is* level order, and the global-BFS order restricted to
    a subtree equals the subtree's own level order."""
    a, b = flat.level_band(trees, lo, hi)
    cand, cnt = _ranges_concat(a, b)
    owner = np.repeat(np.arange(len(nodes), dtype=np.int64), cnt)
    keep = ((flat.pre[cand] >= flat.pre[nodes][owner])
            & (flat.pre[cand] < flat.post[nodes][owner]))
    return cand[keep], owner[keep]


class VectorizedPrefetchEngine:
    """Drop-in :class:`PrefetchEngine` twin: same constructor shape, same
    ``on_request``/``replace_index``/``index`` surface, identical outputs
    (differentially pinned), one array program per request."""

    def __init__(self, index: PTreeIndex, cfg: HeuristicConfig,
                 max_contexts: int = 256, backend: str = "numpy",
                 device=None):
        if backend not in ("numpy", "torch"):
            raise ValueError(f"unknown decision backend {backend!r}")
        self.cfg = cfg
        self.max_contexts = max_contexts
        self.backend = backend
        #: where the torch backend's forest lives (unused by numpy)
        self.device = resolve_device(device) if backend == "torch" else None
        self._progressive = cfg.name == "fetch_progressive"
        self._p_depth = cfg.progressive_depth
        m = max_contexts
        self._node = np.zeros(m, np.int64)
        self._tree = np.zeros(m, np.int64)
        self._fetched = np.zeros(m, np.int64)   # torch path only (numpy
        self._n = 0                             # waves don't need it)
        self._op = 0
        # Palpascope attribution: when enabled, ``on_request`` also
        # records the forest node id behind each emitted item so
        # ``last_attribution`` can name the pattern that caused it.
        # Off by default — the decision microbenchmarks measure the
        # bare walk.
        self.attribute = False
        self._last_nodes: np.ndarray | None = None
        self.replace_index(index)

    # ------------------------------------------------------------------
    @property
    def n_live(self) -> int:
        return self._n

    def replace_index(self, index: PTreeIndex) -> None:
        """Fresh mining generation: flatten it once, precompute the
        per-tree initial waves, drop stale contexts.  Re-installing the
        generation already live only drops the contexts — the flattened
        arrays are immutable, so recompiling them would change nothing."""
        if index is getattr(self, "index", None):
            self._n = 0
            return
        self.index = index
        self.flat = index.flatten()
        self._n = 0
        self._precompute_waves()
        if self.backend == "torch":
            from ..kernels.decision_walk import ops as _ops
            self._dev_forest = _ops.device_forest(self.flat, self.device)

    def _precompute_waves(self) -> None:
        flat, cfg = self.flat, self.cfg
        T = flat.n_trees
        ts, te = flat.tree_start[:-1], flat.tree_start[1:]
        if T == 0:
            self._wave_off = np.zeros(1, np.int64)
            self._wave_nodes = np.empty(0, np.int64)
            self._init_fetched = np.empty(0, np.int64)
            return
        if cfg.name == "fetch_all":
            a, b = ts + 1, te            # every non-root node, level order
        elif cfg.name == "fetch_top_n":
            self._precompute_top_n()
            return
        else:
            # progressive: levels 1..min(progressive_depth, max_depth)
            hi = np.minimum(self._p_depth, flat.tree_max_depth)
            a, b = flat.level_band(np.arange(T, dtype=np.int64),
                                   np.ones(T, np.int64), hi)
            self._init_fetched = hi
            self._precompute_advancement()
        nodes, cnt = _ranges_concat(a, b)
        self._wave_nodes = nodes
        self._wave_off = np.concatenate(
            [np.zeros(1, np.int64), np.cumsum(cnt)])
        if cfg.name == "fetch_all":
            self._init_fetched = flat.tree_max_depth

    def _precompute_advancement(self) -> None:
        """Per-node advancement waves, exact by invariant: a context's
        ``fetched`` is always ``depth + p_depth`` after any emission (the
        open wave seeds it, every advancement tops it up), so advancing
        onto node ``v`` always emits exactly ``subtree(v)`` ∩ level
        ``depth(v) + p_depth`` — the descendants at distance ``p_depth``.
        Grouping those by ancestor turns per-op wave selection into CSR
        slice gathers (``_adv_off``/``_adv_items``), no searchsorted, no
        masks.  Total storage is < one id per node: each node appears in
        at most one ancestor's wave."""
        flat = self.flat
        n = flat.n_nodes
        self._nonterm = ~((flat.depth >= flat.tree_max_depth[flat.tree_of])
                          | (flat.n_children == 0))
        parent = np.full(n, -1, np.int64)
        ch, _ = _ranges_concat(flat.first_child,
                               flat.first_child + flat.n_children)
        parent[ch] = np.repeat(np.arange(n, dtype=np.int64),
                               flat.n_children)
        anc = np.arange(n, dtype=np.int64)
        for _ in range(self._p_depth):
            anc = np.where(anc >= 0, parent[anc], -1)
        u = np.flatnonzero(anc >= 0)
        owner = anc[u]
        order = np.lexsort((u, owner))   # per owner: id asc = level order
        u, owner = u[order], owner[order]
        cnt = np.bincount(owner, minlength=n)
        self._adv_off = np.concatenate(
            [np.zeros(1, np.int64), np.cumsum(cnt)]).astype(np.int64)
        self._adv_items = flat.items[u]
        self._adv_nodes = u                     # parallel: node behind item
        # narrow waves additionally get a fixed-width padded item matrix:
        # one row gather + one sentinel filter per op instead of ragged
        # range assembly.  Guarded by width so a bushy generation can't
        # blow up memory n_nodes × max-branching.
        width = int(cnt.max()) if len(cnt) else 0
        self._adv_pad = None
        self._adv_pad_nodes = None
        if 0 < width <= 8:
            pad = np.full((n, width), -1, np.int64)
            col = np.arange(len(u), dtype=np.int64) - np.repeat(
                self._adv_off[:-1], cnt)
            pad[owner, col] = self._adv_items
            self._adv_pad = pad
            padn = np.full((n, width), -1, np.int64)
            padn[owner, col] = u
            self._adv_pad_nodes = padn
        # sentinel-padded edge table: searchsorted positions can be used
        # unclipped (keys never reach int64 max)
        self._ek = np.concatenate(
            [flat.edge_keys, [np.iinfo(np.int64).max]])
        self._ec = np.concatenate([flat.edge_child, [0]])

    def _precompute_top_n(self) -> None:
        """Per-tree top-k frontier: select k non-root nodes by (cum_prob
        desc, depth asc, level-order asc), then emit (depth asc, cum_prob
        desc, selection order) — both stable, matching the oracle's
        ``heapq.nlargest`` + stable sort exactly."""
        flat, k = self.flat, self.cfg.top_n
        cand = np.flatnonzero(flat.depth > 0)
        tree = flat.tree_of[cand]
        order = np.lexsort((cand, flat.depth[cand],
                            -flat.cum_prob[cand], tree))
        st = tree[order]
        # rank within each tree group of the (tree-major) selection order
        starts = np.searchsorted(st, np.arange(flat.n_trees))
        rank = np.arange(len(order)) - np.repeat(
            starts, np.diff(np.concatenate([starts, [len(order)]])))
        selpos = order[rank < k]
        sel = cand[selpos]
        fin = np.lexsort((np.arange(len(sel)), -flat.cum_prob[sel],
                          flat.depth[sel], flat.tree_of[sel]))
        self._wave_nodes = sel[fin]
        cnts = np.bincount(flat.tree_of[sel], minlength=flat.n_trees)
        self._wave_off = np.concatenate(
            [np.zeros(1, np.int64), np.cumsum(cnts)]).astype(np.int64)
        self._init_fetched = flat.tree_max_depth

    # ------------------------------------------------------------------
    def _advance(self, item: int) -> tuple[list[np.ndarray],
                                           list[np.ndarray]]:
        """Advance all live contexts; returns the advancement wave item
        arrays (context-major) plus — when ``attribute`` is on — the
        parallel wave node-id arrays, and compacts the survivors in
        place."""
        n = self._n
        flat = self.flat
        nodes, trees = self._node[:n], self._tree[:n]
        if self.backend == "torch":
            from ..kernels.decision_walk import ops as _ops
            st = _ops.decision_walk(
                self._dev_forest, flat, nodes, trees, self._fetched[:n],
                item, self._p_depth, max_contexts=self.max_contexts)
            parts: list[np.ndarray] = []
            nparts: list[np.ndarray] = []
            if len(st["wave_nodes"]):
                wn = np.asarray(st["wave_nodes"])
                parts.append(flat.items[wn])
                if self.attribute:
                    nparts.append(wn)
            keep = st["alive"]
            k = int(keep.sum())
            self._node[:k] = st["nodes"][keep]
            self._tree[:k] = trees[keep]
            self._fetched[:k] = st["fetched"][keep]
            self._n = k
            return parts, nparts
        # numpy fast path: one searchsorted advances every context; the
        # wave is a precomputed CSR slice per advanced-onto node (see
        # _precompute_advancement for why that is exact, not a cache)
        if not flat.edge_keys.size or not 0 <= item < flat.item_stride:
            self._n = 0              # nothing matches, nothing can stay
            return [], []
        keys = nodes * flat.item_stride + item
        pos = self._ek.searchsorted(keys)
        found = self._ek[pos] == keys
        if found.all():
            new_nodes = self._ec[pos]
            alive = self._nonterm[new_nodes]
            em = new_nodes
        else:
            new_nodes = np.where(found, self._ec[pos], nodes)
            # a re-confirmed root survives in place (no wave, no reopen)
            stay = (~found & (nodes == flat.tree_start[trees])
                    & (flat.items[nodes] == item))
            alive = (found & self._nonterm[new_nodes]) | stay
            em = new_nodes[found]
        nparts = []
        if self._adv_pad is not None and not self.attribute:
            w = self._adv_pad[em].ravel()
            w = w[w >= 0]
            parts = [w] if len(w) else []
        elif self._adv_pad is not None:
            w = self._adv_pad[em].ravel()
            mask = w >= 0
            w = w[mask]
            parts = [w] if len(w) else []
            if len(w):
                nparts = [self._adv_pad_nodes[em].ravel()[mask]]
        else:
            idx, _ = _ranges_concat(self._adv_off[em],
                                    self._adv_off[em + 1])
            parts = [self._adv_items[idx]] if len(idx) else []
            if len(idx) and self.attribute:
                nparts = [self._adv_nodes[idx]]
        if alive.all():
            self._node[:n] = new_nodes
        else:
            k = int(alive.sum())
            self._node[:k] = new_nodes[alive]
            self._tree[:k] = trees[alive]
            self._n = k
        return parts, nparts

    def on_request(self, item: int) -> list[int]:
        """Returns item ids to prefetch (deduplicated, wave order kept) —
        one array program regardless of how many contexts are live."""
        self._op += 1
        item = int(item)
        parts, nparts = self._advance(item) if self._n else ([], [])
        flat = self.flat
        t = flat.root_tree.get(item)
        if t is not None:
            root_id = flat.tree_start[t]
            n = self._n
            dup = n and bool(
                ((self._tree[:n] == t) & (self._node[:n] == root_id)).any())
            if not dup:     # a live duplicate just stays; never reopened
                w = self._wave_nodes[self._wave_off[t]:self._wave_off[t + 1]]
                if len(w):
                    parts.append(flat.items[w])
                    if self.attribute:
                        nparts.append(w)
                if self._progressive and flat.tree_max_depth[t] > 0:
                    if self._n >= self.max_contexts:
                        # evict the stalest context.  Every surviving
                        # context is re-confirmed (advance or root-stay)
                        # on every op it outlives, so the least-recently
                        # confirmed is always the oldest list position —
                        # the scalar oracle's explicit stamp argmin
                        # resolves to index 0 for the same reason.
                        for arr in (self._node, self._tree, self._fetched):
                            arr[:self._n - 1] = arr[1:self._n].copy()
                        self._n -= 1
                    i = self._n
                    self._node[i] = root_id
                    self._tree[i] = t
                    self._fetched[i] = self._init_fetched[t]
                    self._n = i + 1
        if not parts:
            self._last_nodes = None
            return []
        wave = parts[0] if len(parts) == 1 else np.concatenate(parts)
        # first-occurrence dedup, wave order kept (np.unique semantics,
        # without its python dispatch layers — this runs every op)
        order = wave.argsort(kind="stable")
        sw = wave[order]
        m = np.empty(len(sw), bool)
        m[:1] = True
        np.not_equal(sw[1:], sw[:-1], out=m[1:])
        first = order[m]
        first.sort()
        if self.attribute:
            nodes = nparts[0] if len(nparts) == 1 else np.concatenate(nparts)
            self._last_nodes = nodes[first]
        else:
            self._last_nodes = None
        return wave[first].tolist()

    def last_attribution(self) -> list[PrefetchCause]:
        """One :class:`PrefetchCause` per item of the last ``on_request``
        return (same order): the emitting node's tree root item, its
        depth (= confirmed-prefix length), the heuristic, and the
        node's cumulative confidence.  Empty unless ``attribute``."""
        nodes = self._last_nodes
        if nodes is None or not len(nodes):
            return []
        flat = self.flat
        roots = flat.items[flat.tree_start[flat.tree_of[nodes]]]
        h = self.cfg.name
        return [PrefetchCause(int(r), int(d), h, float(c))
                for r, d, c in zip(roots.tolist(),
                                   flat.depth[nodes].tolist(),
                                   flat.cum_prob[nodes].tolist())]


def build_engine(index: PTreeIndex, cfg: HeuristicConfig,
                 max_contexts: int = 256, use_vectorized: bool = True,
                 backend: str = "numpy", device=None):
    """Engine factory the clients share: the vectorized array walk by
    default, the scalar oracle when ``use_vectorized=False``."""
    if use_vectorized:
        return VectorizedPrefetchEngine(index, cfg, max_contexts,
                                        backend=backend, device=device)
    return PrefetchEngine(index, cfg, max_contexts)
