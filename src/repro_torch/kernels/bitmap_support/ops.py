"""Public wrappers of the VMSP support-join kernels.

The port's counterpart of ``src/repro/kernels/bitmap_support/ops.py``.
Words are ``int32`` tensors holding the miner's ``uint32`` bitmaps.

* On CPU tensors a wrapper runs the plain version in :mod:`.ref`.
* On CUDA tensors it launches the hand-written kernel of
  ``csrc/bitmap_support.cu`` (built at first use) or raises.  It never
  falls back.

The frontier kernel joins only the (prefix, session) pairs with a nonzero
slot word, against :func:`session_major` of the candidates; its grid is
:func:`frontier_plan`.  The s-step kernel reads a candidate word only
where its slot word is nonzero and writes ``joined`` whole; its grid is
:func:`sstep_plan`.

``counts`` holds the kernel launches since the last reset: a wrapper adds
one where it launches its kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from pathlib import Path
from typing import Optional

import torch

from .. import _build
from .._launch import launch_args, on_cpu
from . import ref

__all__ = ["frontier_join_support", "sstep_join_support", "session_major",
           "frontier_plan", "FrontierPlan", "sstep_plan", "SstepPlan",
           "counts", "load"]

_SOURCES = (Path(__file__).resolve().parent / "csrc" / "bitmap_support.cu",)
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # slots, cand_t, support, P, K, S, W, n_ranges, n_tiles, k_chunks,
    # kpt, device, stream
    "frontier_join_support_launch": [_P, _P, _P, *[_I] * 9, _P],
    # slots, cand, joined, support, K, S, W, vec, n_ranges, k_per_block,
    # device, stream
    "sstep_join_support_launch": [_P, _P, _P, _P, *[_I] * 7, _P],
}
_TILE_ROWS = 8          # kTileRows: prefixes per block of the frontier kernel
_JOIN_THREADS = 256     # kJoinThreads: its threads and sessions per block
_KPT = (1, 2, 4)        # candidates a thread may hold
_SSTEP_THREADS = 256    # kSstepThreads: the s-step kernel's threads a block
_SSTEP_MAX_K = 32       # kSstepMaxK: its candidates a block, at most
#: blocks the s-step grid aims for: four for each of the H100's 132 SMs
_SSTEP_BLOCKS = 4 * 132
_INT_MAX = 2 ** 31 - 1

#: kernel launches since the last reset
counts = {"frontier_join_support": 0, "sstep_join_support": 0}


def load() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' library."""
    return _build.load_library("bitmap_support", _SOURCES, _SIGNATURES)


def _check(name: str, t: torch.Tensor, ndim: int) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32 words, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {t.dim()}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


@dataclasses.dataclass(frozen=True)
class FrontierPlan:
    """The frontier kernel's grid: ``k_chunks * n_tiles * n_ranges``
    blocks (ranges fastest), each owning a tile of ``_TILE_ROWS``
    prefixes, a range of ``_JOIN_THREADS`` sessions and ``kpt *
    _JOIN_THREADS`` candidates."""

    n_ranges: int
    n_tiles: int
    k_chunks: int
    kpt: int

    @property
    def blocks(self) -> int:
        return self.k_chunks * self.n_tiles * self.n_ranges


def frontier_plan(p_prefixes: int, k_items: int,
                  n_sessions: int) -> FrontierPlan:
    """The grid that covers every (prefix, session, candidate) once."""
    kpt = next((c for c in _KPT if k_items <= c * _JOIN_THREADS), _KPT[-1])
    return FrontierPlan(
        n_ranges=math.ceil(n_sessions / _JOIN_THREADS),
        n_tiles=math.ceil(p_prefixes / _TILE_ROWS),
        k_chunks=math.ceil(k_items / (kpt * _JOIN_THREADS)), kpt=kpt)


@dataclasses.dataclass(frozen=True)
class SstepPlan:
    """The s-step kernel's grid: ``k_blocks * n_ranges`` blocks (ranges
    fastest), each owning ``_SSTEP_THREADS * vec`` sessions and
    ``k_per_block`` candidates; ``vec`` is the sessions a thread owns."""

    vec: int
    n_ranges: int
    k_per_block: int
    k_blocks: int

    @property
    def blocks(self) -> int:
        return self.k_blocks * self.n_ranges


def sstep_plan(k_items: int, n_sessions: int, n_words: int,
               aligned: bool = True) -> SstepPlan:
    """The grid that covers every (session, candidate) once: 4 one-word
    sessions a thread (16-byte loads and stores) where ``n_words`` is 1,
    ``n_sessions`` a multiple of 4 and the bases ``aligned`` to 16 bytes,
    else one; candidates spread over blocks until the grid has about
    :data:`_SSTEP_BLOCKS` blocks."""
    vec = 4 if n_words == 1 and n_sessions % 4 == 0 and aligned else 1
    n_ranges = max(1, math.ceil(n_sessions // vec / _SSTEP_THREADS))
    k_per_block = min(_SSTEP_MAX_K, max(1, math.ceil(
        k_items * n_ranges / _SSTEP_BLOCKS)))
    return SstepPlan(vec=vec, n_ranges=n_ranges, k_per_block=k_per_block,
                     k_blocks=math.ceil(k_items / k_per_block))


def session_major(cand: torch.Tensor) -> Optional[torch.Tensor]:
    """The (S, K, W) copy of ``cand`` that the frontier kernel reads, one
    session's candidate words contiguous; ``None`` on the CPU, whose plain
    version reads ``cand`` as it is.  ``cand`` is fixed for a whole
    lattice walk, so the miner makes this copy once per walk."""
    if on_cpu(cand):
        return None
    return cand.transpose(0, 1).contiguous()


def frontier_join_support(slots: torch.Tensor, cand: torch.Tensor,
                          cand_t: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """(P, S, W) × (K, S, W) int32 -> support (P, K) int32: the number of
    sessions where ``slots[p] & cand[k]`` has a nonzero word.

    ``cand_t`` is :func:`session_major` of ``cand``, which the kernel
    reads; without it the wrapper makes it (one more launch)."""
    _check("slots", slots, 3)
    _check("cand", cand, 3)
    p_prefixes, n_sessions, n_words = slots.shape
    k_items = cand.shape[0]
    if cand.shape[1:] != slots.shape[1:]:
        raise ValueError(f"cand {tuple(cand.shape)} does not match "
                         f"slots {tuple(slots.shape)}")
    if cand_t is not None:
        _check("cand_t", cand_t, 3)
        if cand_t.shape != (n_sessions, k_items, n_words):
            raise ValueError(f"cand_t {tuple(cand_t.shape)} is not the "
                             f"session-major copy of cand "
                             f"{tuple(cand.shape)}")
    if on_cpu(slots, cand, *(() if cand_t is None else (cand_t,))):
        return ref.frontier_join_support(slots, cand)
    if min(p_prefixes, k_items, n_sessions, n_words) == 0:
        return torch.zeros((p_prefixes, k_items), dtype=torch.int32,
                           device=slots.device)
    if max(p_prefixes, k_items, n_sessions * n_words) > _INT_MAX:
        raise ValueError("frontier too large for 32-bit indices")
    if cand_t is None:
        cand_t = session_major(cand)
    dev, stream = launch_args(slots)
    plan = frontier_plan(p_prefixes, k_items, n_sessions)
    support = torch.empty((p_prefixes, k_items), dtype=torch.int32,
                          device=slots.device)    # zeroed by the launcher
    err = load().frontier_join_support_launch(
        slots.data_ptr(), cand_t.data_ptr(), support.data_ptr(),
        p_prefixes, k_items, n_sessions, n_words, plan.n_ranges,
        plan.n_tiles, plan.k_chunks, plan.kpt, dev, stream)
    if err:
        raise RuntimeError(f"frontier_join_support launch failed: "
                           f"CUDA error {err}")
    counts["frontier_join_support"] += 1
    return support


def sstep_join_support(slots: torch.Tensor, cand: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(S, W) × (K, S, W) int32 -> joined (K, S, W) int32 and support
    (K,) int32: ``joined[k] = slots & cand[k]`` and the number of
    sessions where it has a nonzero word."""
    _check("slots", slots, 2)
    _check("cand", cand, 3)
    k_items, n_sessions, n_words = cand.shape
    if tuple(slots.shape) != (n_sessions, n_words):
        raise ValueError(f"slots {tuple(slots.shape)} does not match "
                         f"cand {tuple(cand.shape)}")
    if on_cpu(slots, cand):
        return ref.sstep_join_support(slots, cand)
    joined = torch.empty_like(cand)
    if min(k_items, n_sessions, n_words) == 0:
        return joined, torch.zeros((k_items,), dtype=torch.int32,
                                   device=cand.device)
    if max(k_items, n_sessions * n_words) > _INT_MAX:
        raise ValueError("join too large for 32-bit indices")
    aligned = all(t.data_ptr() % 16 == 0 for t in (slots, cand, joined))
    plan = sstep_plan(k_items, n_sessions, n_words, aligned)
    dev, stream = launch_args(cand)
    support = torch.empty((k_items,), dtype=torch.int32,
                          device=cand.device)   # zeroed by the launcher
    err = load().sstep_join_support_launch(
        slots.data_ptr(), cand.data_ptr(), joined.data_ptr(),
        support.data_ptr(), k_items, n_sessions, n_words, plan.vec,
        plan.n_ranges, plan.k_per_block, dev, stream)
    if err:
        raise RuntimeError(f"sstep_join_support launch failed: "
                           f"CUDA error {err}")
    counts["sstep_join_support"] += 1
    return joined, support
