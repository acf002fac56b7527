"""Sequential pattern mining (Palpatine §3.2) with the bitmaps on the device.

The port of ``src/repro/core/mining.py``: the same algorithm families
(``gsp``, ``spam``, ``prefixspan``, ``vmsp``) under the same constraints,
giving the same patterns in the same order.  What moved to the device:

* :class:`VerticalBitmaps` builds its packed ``(K, S, W)`` bitmaps on the
  device.  Words are ``int32`` tensors holding the reference's ``uint32``
  bits (torch has no shifts on ``uint32`` on the CPU).  ``freq_items``,
  ``freq_support`` and ``_row_of`` stay small numpy arrays on the host,
  equal to the reference's.
* The level-synchronous frontier walk keeps the frontier ``(P, S, W)``,
  the candidates ``(K, S, W)``, the extension slots and the joined
  surviving pairs on the device.  Only the ``(P, K)`` support matrix
  comes back to the host each level, for the pattern bookkeeping.
* Support joins go through :mod:`repro_torch.kernels.bitmap_support`:
  the frontier join on the main path, the s-step join on the DFS spill
  path.  On a CUDA device they are hand-written kernels; on the CPU,
  their plain PyTorch versions.  The device decides:
  ``MiningParams.use_kernel`` is kept for the reference's signature and
  ignored.

The spill rule is the reference's: a walk whose single-prefix ``K×S×W``
join exceeds ``frontier_budget`` bytes runs the per-node DFS walker, whose
emission order differs from the frontier's.  The maximal filter, the
dynamic minsup loop, PrefixSpan and the brute-force oracle are host code,
copied unchanged.
"""

from __future__ import annotations

import dataclasses
import math
from collections import Counter
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.bitmap_support import ops as _ops
from .sessions import SequenceDatabase

__all__ = [
    "MiningParams",
    "Pattern",
    "VerticalBitmaps",
    "BITMAP_ALGOS",
    "bitmaps_from_numpy",
    "mine",
    "gsp",
    "spam",
    "prefixspan",
    "vmsp",
    "maximal_filter",
    "mine_dynamic_minsup",
    "dynamic_floor_count",
    "brute_force",
]

_WORD = 32         # bits per packed word
_ALL_ONES = -1     # the word 0xFFFFFFFF as an int32

DeviceLike = Optional[Union[str, torch.device]]


@dataclasses.dataclass(frozen=True)
class MiningParams:
    """User-specific constraints (paper §3.2 / §5 'Pattern mining')."""

    minsup: float = 0.1          # fraction of sessions
    min_len: int = 3
    max_len: int = 15
    maxgap: Optional[int] = 1    # 1 = contiguous (paper default); None = any
    use_kernel: bool = False     # ignored: the bitmaps' device decides
    # byte cap on the frontier engine's transient join tensor; a walk whose
    # single-prefix K×S×W join exceeds it falls back to the DFS walker
    frontier_budget: int = 64 * 1024 * 1024

    def minsup_count(self, n_sessions: int) -> int:
        return max(1, int(math.ceil(self.minsup * n_sessions)))


@dataclasses.dataclass(frozen=True)
class Pattern:
    items: tuple
    support: int

    def __len__(self) -> int:
        return len(self.items)


# ---------------------------------------------------------------------------
# Vertical packed-bitmap engine (SPAM / VMSP representation)
# ---------------------------------------------------------------------------


def _to_words(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 words with the same 32 bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


class VerticalBitmaps:
    """Per-item occurrence bitmaps for the frequent items, packed 32
    positions/word, on ``device``.

    ``bits[r]`` has shape (n_sessions, n_words); bit ``p % 32`` of word
    ``p // 32`` for session ``s`` is set iff item ``freq_items[r]`` occurs at
    position ``p`` of session ``s``.  Padding positions are never set, so
    joining with an item bitmap implicitly masks shifted-past-the-end bits.
    """

    def __init__(self, db: SequenceDatabase, minsup_count: int = 1,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        mat, _ = db.padded_matrix()
        self.n_sessions = mat.shape[0]
        max_len = mat.shape[1] if mat.size else 0
        self.n_words = max(1, (max_len + _WORD - 1) // _WORD)
        n_items = db.n_items

        if not mat.size:
            self.freq_items = np.zeros((0,), np.int32)
            self.freq_support = np.zeros((0,), np.int64)
            self._row_of = np.full(n_items, -1, np.int32)
            self.bits = torch.zeros((0, self.n_sessions, self.n_words),
                                    dtype=torch.int32, device=self.device)
            return
        m = torch.from_numpy(mat).to(self.device)
        # item support = #sessions containing the item: sorting each row
        # puts its duplicates side by side, so count first occurrences
        sm = torch.sort(m, dim=1).values
        first = sm >= 0                        # drop -1 padding
        first[:, 1:] &= sm[:, 1:] != sm[:, :-1]
        per_item = torch.bincount(sm[first].long(), minlength=n_items)
        freq = torch.nonzero(per_item >= minsup_count).flatten()
        row_of = torch.full((n_items,), -1, dtype=torch.int64,
                            device=self.device)
        row_of[freq] = torch.arange(freq.numel(), device=self.device)

        sess, pos = torch.nonzero(m >= 0, as_tuple=True)
        rows = row_of[m[sess, pos].long()]
        keep = rows >= 0
        sess, pos, rows = sess[keep], pos[keep], rows[keep]
        # torch has no scatter-OR, but each (session, position) sets one
        # bit of one word exactly once, so an integer sum builds the words
        words = torch.zeros(freq.numel() * self.n_sessions * self.n_words,
                            dtype=torch.int64, device=self.device)
        flat = (rows * self.n_sessions + sess) * self.n_words + pos // _WORD
        words.index_put_((flat,), torch.ones_like(flat) << (pos % _WORD),
                         accumulate=True)
        self.bits = _to_words(words).view(
            freq.numel(), self.n_sessions, self.n_words)
        self.freq_items = freq.cpu().numpy().astype(np.int32)
        self.freq_support = per_item[freq].cpu().numpy().astype(np.int64)
        self._row_of = row_of.cpu().numpy().astype(np.int32)

    def row(self, item_id: int) -> int:
        r = int(self._row_of[item_id])
        if r < 0:
            raise KeyError(f"item {item_id} is not frequent")
        return r

    # -- primitive ops ------------------------------------------------------
    @staticmethod
    def shift1(b: torch.Tensor) -> torch.Tensor:
        """Move every set bit one position later (possible extension slots
        for maxgap=1).  Works on (..., n_words)."""
        carry = torch.zeros_like(b)
        # >> on int32 is arithmetic: keep only the former bit 31
        carry[..., 1:] = (b[..., :-1] >> 31) & 1
        return (b << 1) | carry

    @classmethod
    def smear_after(cls, b: torch.Tensor) -> torch.Tensor:
        """Set all positions strictly after the first set bit per session
        (SPAM's s-step transform for unconstrained gap)."""
        x = b.clone()
        for k in (1, 2, 4, 8, 16):  # within-word smear toward higher bits
            x |= x << k
        after = cls.shift1(x)
        # any earlier word nonzero -> whole word saturates
        nz = (b != 0).to(torch.int64)
        earlier = torch.cumsum(nz, dim=-1) - nz  # nonzero earlier words
        after[earlier > 0] = _ALL_ONES
        return after

    def extension_slots(self, b: torch.Tensor,
                        maxgap: Optional[int]) -> torch.Tensor:
        if maxgap is None:
            return self.smear_after(b)
        out = self.shift1(b)
        acc = out
        for _ in range(maxgap - 1):
            acc = self.shift1(acc)
            out = out | acc
        return out

    @staticmethod
    def support(b: torch.Tensor) -> torch.Tensor:
        """#sessions with >=1 set bit.  (..., S, W) -> (...,)."""
        return (b != 0).any(-1).sum(-1)


def bitmaps_from_numpy(bits: np.ndarray, freq_items: np.ndarray,
                       freq_support: np.ndarray, row_of: np.ndarray,
                       n_sessions: int, n_words: int,
                       device: DeviceLike = None) -> VerticalBitmaps:
    """The reference's ``VerticalBitmaps`` fields (numpy, ``uint32`` words)
    as the port's device bitmaps, so both packages can mine one set."""
    vb = object.__new__(VerticalBitmaps)
    vb.device = resolve_device(device)
    vb.n_sessions, vb.n_words = int(n_sessions), int(n_words)
    vb.freq_items = np.asarray(freq_items, np.int32)
    vb.freq_support = np.asarray(freq_support, np.int64)
    vb._row_of = np.asarray(row_of, np.int32)
    words = np.ascontiguousarray(bits, np.uint32).view(np.int32)
    vb.bits = torch.from_numpy(words).to(vb.device)
    return vb


# ---------------------------------------------------------------------------
# Frontier engine — level-synchronous lattice walk, fused (P×K) support join
# ---------------------------------------------------------------------------


def _frontier_support(
    slots: torch.Tensor,
    cand: torch.Tensor,
    allowed: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Fused support count for a whole frontier: (P,S,W) × (K,S,W) -> (P,K)
    int64 on the host.

    The join is dense: every (prefix, item, session) is joined by the
    ``frontier_join_support`` kernel (its plain version on the CPU).
    ``allowed`` is an optional (P,K) bool mask of candidate extensions per
    prefix (apriori narrowing for maxgap=None); disallowed pairs report
    support 0, as in the reference.
    """
    p_prefixes, k_items = slots.shape[0], cand.shape[0]
    if p_prefixes == 0 or k_items == 0:
        return np.zeros((p_prefixes, k_items), np.int64)
    sup = _ops.frontier_join_support(slots.contiguous(), cand)
    sup = sup.cpu().numpy().astype(np.int64)
    if allowed is not None:
        sup[~allowed] = 0
    return sup


def _dfs_expand(
    vb: VerticalBitmaps,
    params: MiningParams,
    msc: int,
    cand: torch.Tensor,
    cand_items: np.ndarray,
    pattern: tuple,
    pbits: torch.Tensor,
    sup: int,
    maximal_only: bool,
    out: list,
) -> None:
    """Per-node DFS from one lattice node (the spill target when a
    frontier level exceeds the byte budget).  One s-step join per node;
    its supports come to the host to choose the children."""
    has_freq_ext = False
    if len(pattern) < params.max_len and cand.shape[0]:
        slots = vb.extension_slots(pbits, params.maxgap).contiguous()
        joined, sups = _ops.sstep_join_support(slots, cand)
        sups = sups.cpu().numpy()
        for k in np.nonzero(sups >= msc)[0]:
            has_freq_ext = True
            _dfs_expand(
                vb, params, msc, cand, cand_items,
                pattern + (int(cand_items[k]),), joined[k], int(sups[k]),
                maximal_only, out,
            )
    if len(pattern) >= params.min_len and (not maximal_only or not has_freq_ext):
        out.append(Pattern(pattern, int(sup)))


def _dfs_mine(
    vb: VerticalBitmaps,
    params: MiningParams,
    msc: int,
    rows: np.ndarray,
    maximal_only: bool,
) -> list[Pattern]:
    """Per-node DFS lattice walk over the candidate ``rows``."""
    cand = vb.bits[torch.as_tensor(rows, device=vb.device)]
    cand_items = vb.freq_items[rows]
    out: list[Pattern] = []
    for i, r in enumerate(rows):
        _dfs_expand(
            vb, params, msc, cand, cand_items,
            (int(cand_items[i]),), vb.bits[int(r)], int(vb.freq_support[r]),
            maximal_only, out,
        )
    return out


def _frontier_mine(
    db: SequenceDatabase,
    params: MiningParams,
    maximal_only: bool,
    vb: Optional[VerticalBitmaps] = None,
    device: DeviceLike = None,
) -> list[Pattern]:
    """Level-synchronous frontier miner (see module docstring).

    Byte-identical Pattern output to :func:`_dfs_mine` (set-wise; emission
    order is per-level instead of depth-first)."""
    msc = params.minsup_count(len(db))
    if vb is None:
        vb = VerticalBitmaps(db, msc, device)
    rows = np.nonzero(vb.freq_support >= msc)[0]
    out: list[Pattern] = []
    if rows.size == 0:
        return out

    k_items = rows.size
    per_prefix_bytes = k_items * vb.n_sessions * vb.n_words * 4
    if per_prefix_bytes > params.frontier_budget:
        # even a single prefix's K×S×W join exceeds the byte cap (the
        # quantity is walk-invariant, so this is a whole-walk decision):
        # fall back to the per-node DFS walker
        return _dfs_mine(vb, params, msc, rows, maximal_only)

    cand = vb.bits[torch.as_tensor(rows, device=vb.device)]  # (K, S, W)
    cand_items = vb.freq_items[rows]
    patterns: list[tuple] = [(int(it),) for it in cand_items]
    fbits = cand                              # depth-1 frontier = item bitmaps
    fsups = vb.freq_support[rows].astype(np.int64)
    # per-branch candidate narrowing: for unconstrained gap a child's
    # frequent extensions are a subset of its parent's (dropping the last
    # prefix item keeps any occurrence a subsequence), so each frontier
    # entry only joins against its parent's surviving extension set.  The
    # containment argument needs gap-free subsequence semantics — a
    # contiguous (maxgap-constrained) occurrence of the child need not
    # contain one of the parent+item — so the gap rule gates it and
    # contiguous walks keep the full candidate set.
    narrow = params.maxgap is None
    allowed: Optional[np.ndarray] = None      # (P, K) mask; None = all
    depth = 1
    while patterns:
        if depth >= params.max_len:
            # no further expansion possible: every frontier pattern is
            # emitted (the DFS likewise skips the forward-extension check
            # at max_len)
            if depth >= params.min_len:
                out.extend(Pattern(p, int(s)) for p, s in zip(patterns, fsups))
            break
        # extension slots for the whole frontier, once per level
        slots = vb.extension_slots(fbits, params.maxgap)
        sup = _frontier_support(slots, cand, allowed=allowed)  # (P, K) host
        surv = sup >= msc
        has_ext = surv.any(axis=1)                         # maximality mask
        if depth >= params.min_len:
            for p in np.nonzero(~has_ext)[0] if maximal_only else range(len(patterns)):
                out.append(Pattern(patterns[p], int(fsups[p])))
        pidx, kidx = np.nonzero(surv)                      # row-major
        if pidx.size == 0:
            break
        # materialize joined bitmaps only for the surviving (prefix, item)
        # pairs — they *are* the next frontier, and stay on the device
        fbits = (slots[torch.as_tensor(pidx, device=vb.device)]
                 & cand[torch.as_tensor(kidx, device=vb.device)])
        fsups = sup[pidx, kidx]
        patterns = [
            patterns[p] + (int(cand_items[k]),) for p, k in zip(pidx, kidx)
        ]
        if narrow:
            # child (p, k) inherits p's surviving extension row
            allowed = surv[pidx]
        depth += 1
    return out


# ---------------------------------------------------------------------------
# SPAM — vertical bitmaps, all frequent sequential patterns
# ---------------------------------------------------------------------------


def spam(
    db: SequenceDatabase,
    params: MiningParams,
    vb: Optional[VerticalBitmaps] = None,
    device: DeviceLike = None,
) -> list[Pattern]:
    return _frontier_mine(db, params, maximal_only=False, vb=vb,
                          device=device)


# ---------------------------------------------------------------------------
# VMSP — maximal sequential patterns (the paper's adopted algorithm)
# ---------------------------------------------------------------------------


def maximal_filter(
    patterns: Sequence[Pattern], maxgap: Optional[int]
) -> list[Pattern]:
    """Keep patterns not strictly included in another frequent pattern.

    For the contiguous case (maxgap=1) inclusion = contiguous subsequence;
    otherwise classic subsequence inclusion.  The non-contiguous branch
    buckets accepted maximal patterns by item, so a candidate only scans the
    supersets sharing its rarest item (with an item-multiset prefilter)
    instead of every accepted pattern.
    """
    if not patterns:
        return []
    ordered = sorted(patterns, key=len, reverse=True)
    maximal: list[Pattern] = []
    if maxgap == 1:
        covered: set = set()
        for p in ordered:
            if p.items not in covered:
                maximal.append(p)
                n = len(p.items)
                for i in range(n):
                    for j in range(i + 1, n + 1):
                        if (j - i) < n:
                            covered.add(p.items[i:j])
    else:
        def subseq(a: tuple, b: tuple) -> bool:
            it = iter(b)
            return all(x in it for x in a)

        mcounts: list[Counter] = []       # item multiset per accepted pattern
        buckets: dict = {}                # item -> indices into `maximal`
        for p in ordered:
            pc = Counter(p.items)
            scan: Optional[list] = None   # smallest bucket among p's items
            for it in pc:
                bl = buckets.get(it)
                if bl is None:
                    scan = None           # no accepted pattern contains `it`
                    break
                if scan is None or len(bl) < len(scan):
                    scan = bl
            contained = False
            if scan:
                for mi in scan:
                    m = maximal[mi]
                    if len(m.items) <= len(p.items):
                        continue
                    mc = mcounts[mi]
                    if all(mc[it] >= c for it, c in pc.items()) and subseq(
                        p.items, m.items
                    ):
                        contained = True
                        break
            if not contained:
                idx = len(maximal)
                maximal.append(p)
                mcounts.append(pc)
                for it in pc:
                    buckets.setdefault(it, []).append(idx)
    return maximal


def vmsp(
    db: SequenceDatabase,
    params: MiningParams,
    vb: Optional[VerticalBitmaps] = None,
    device: DeviceLike = None,
) -> list[Pattern]:
    """VMSP-style mining: frontier engine + maximality.

    Non-maximal patterns are pruned during the frontier walk via the
    forward-extension mask (a pattern with a frequent s-extension cannot be
    maximal); a global inclusion filter removes backward/infix containment,
    matching VMSP's output semantics.
    """
    candidates = _frontier_mine(db, params, maximal_only=True, vb=vb,
                                device=device)
    return maximal_filter(candidates, params.maxgap)


# ---------------------------------------------------------------------------
# PrefixSpan — pattern growth with projected databases
# ---------------------------------------------------------------------------


def prefixspan(db: SequenceDatabase, params: MiningParams) -> list[Pattern]:
    msc = params.minsup_count(len(db))
    sessions = db.sessions
    out: list[Pattern] = []

    # initial projection: item -> list of (session, end_position)
    first: dict = {}
    for sid, seq in enumerate(sessions):
        for pos, it in enumerate(seq):
            first.setdefault(it, []).append((sid, pos))

    def proj_support(proj: list) -> int:
        return len({sid for sid, _ in proj})

    def grow(pattern: tuple, proj: list) -> None:
        if len(pattern) >= params.min_len:
            out.append(Pattern(pattern, proj_support(proj)))
        if len(pattern) >= params.max_len:
            return
        nxt: dict = {}
        for sid, pos in proj:
            seq = sessions[sid]
            if params.maxgap is None:
                rng = range(pos + 1, len(seq))
            else:
                rng = range(pos + 1, min(pos + 1 + params.maxgap, len(seq)))
            for q in rng:
                nxt.setdefault(seq[q], []).append((sid, q))
        for it, p in nxt.items():
            if proj_support(p) >= msc:
                grow(pattern + (it,), p)

    for it, proj in first.items():
        if proj_support(proj) >= msc:
            grow((it,), proj)
    return out


# ---------------------------------------------------------------------------
# GSP — Apriori BFS over the frontier engine
# ---------------------------------------------------------------------------


def gsp(
    db: SequenceDatabase,
    params: MiningParams,
    vb: Optional[VerticalBitmaps] = None,
    device: DeviceLike = None,
) -> list[Pattern]:
    """GSP's level-wise walk *is* the frontier engine: each level holds all
    frequent length-d sequences, candidates are their one-item extensions,
    and the apriori property holds by construction (only frequent prefixes
    are extended, only frequent items are candidate tails).  Support counting
    uses the fused vertical-bitmap join instead of horizontal scans."""
    return _frontier_mine(db, params, maximal_only=False, vb=vb,
                          device=device)


# ---------------------------------------------------------------------------
# Oracle + dispatch + dynamic minsup
# ---------------------------------------------------------------------------


def brute_force(db: SequenceDatabase, params: MiningParams) -> list[Pattern]:
    """Exhaustive window/subsequence counter — the test oracle."""
    counts: dict = {}
    for seq in db.sessions:
        seen: set = set()
        if params.maxgap == 1:
            for i in range(len(seq)):
                for j in range(
                    i + params.min_len, min(i + params.max_len, len(seq)) + 1
                ):
                    seen.add(seq[i:j])
        else:
            def expand(path: tuple, pos: int) -> None:
                if len(path) >= params.min_len:
                    seen.add(path)
                if len(path) >= params.max_len:
                    return
                hi = len(seq) if params.maxgap is None else min(
                    pos + 1 + params.maxgap, len(seq)
                )
                for q in range(pos + 1, hi):
                    expand(path + (seq[q],), q)

            for p0 in range(len(seq)):
                expand((seq[p0],), p0)
        # sorted: dict insertion order must not depend on hash-seeded
        # set iteration
        for s in sorted(seen):
            counts[s] = counts.get(s, 0) + 1
    msc = params.minsup_count(len(db))
    # sorted output: the oracle's pattern order is a function of the
    # data alone, never of per-process hash seeds
    return sorted((Pattern(k, v) for k, v in counts.items() if v >= msc),
                  key=lambda p: p.items)


ALGORITHMS: dict[str, Callable] = {
    "gsp": gsp,
    "spam": spam,
    "prefixspan": prefixspan,
    "vmsp": vmsp,
}

#: algorithms that run on the shared VerticalBitmaps engine and accept a
#: prebuilt ``vb`` (incremental dynamic-minsup / backlog-unchanged reuse)
BITMAP_ALGOS = frozenset({"gsp", "spam", "vmsp"})


def mine(
    db: SequenceDatabase,
    params: MiningParams,
    algo: str = "vmsp",
    vb: Optional[VerticalBitmaps] = None,
    device: DeviceLike = None,
) -> list[Pattern]:
    """Mine ``db`` with ``algo``; the bitmap algorithms run on ``vb``'s
    device, or build their bitmaps on ``device``."""
    fn = ALGORITHMS[algo]
    if algo in BITMAP_ALGOS:
        return fn(db, params, vb=vb, device=device)
    return fn(db, params)


def dynamic_floor_count(
    params: MiningParams, n_sessions: int, start: float, floor: float
) -> int:
    """The support count :func:`mine_dynamic_minsup` builds its bitmaps at —
    callers that cache a ``vb`` for it MUST use this same count (a cache
    built at a higher count would silently drop frequent items).  The
    ``min(floor, start)`` clamp guards the start < floor corner, where the
    first (and only) retry mines below the floor."""
    return dataclasses.replace(
        params, minsup=min(floor, start)
    ).minsup_count(n_sessions)


def mine_dynamic_minsup(
    db: SequenceDatabase,
    params: MiningParams,
    algo: str = "vmsp",
    start: float = 0.5,
    floor: float = 0.01,
    decay: float = 0.5,
    min_patterns: int = 16,
    vb: Optional[VerticalBitmaps] = None,
    vb_factory: Optional[Callable[[], VerticalBitmaps]] = None,
    device: DeviceLike = None,
) -> tuple[list[Pattern], float]:
    """Paper §4.2: start with a high minsup and decay it until enough
    frequent sequences are discovered.  Returns (patterns, used_minsup).

    Incremental: for the bitmap algorithms the packed ``VerticalBitmaps``
    are built once at the *floor* support — lazily, on the first decay — and
    re-thresholded per retry (every retry mines at minsup >= floor, so the
    floor-level bitmaps are a superset of what each retry needs; a backlog
    satisfied at ``start`` never pays the floor build).  Pass ``vb`` — built
    at or below the floor count (:func:`dynamic_floor_count`) — to reuse
    bitmaps across calls on an unchanged backlog, or ``vb_factory`` to keep
    the build lazy while still capturing it for caching (it is only invoked
    if a decay retry actually happens, and must build at that same count).
    """
    lazy_floor = vb is None and algo in BITMAP_ALGOS and len(db) > 0
    minsup = start
    patterns: list[Pattern] = []
    while True:
        patterns = mine(db, dataclasses.replace(params, minsup=minsup), algo,
                        vb=vb, device=device)
        if len(patterns) >= min_patterns or minsup <= floor:
            return patterns, minsup
        if lazy_floor and vb is None:
            # first decay: build the floor-level bitmaps once and reuse them
            # for every retry.  Deferred past the first mine so a backlog
            # satisfied at `start` never pays the (much larger) floor build.
            if vb_factory is not None:
                vb = vb_factory()
            else:
                vb = VerticalBitmaps(
                    db, dynamic_floor_count(params, len(db), start, floor),
                    device)
        minsup = max(floor, minsup * decay)
