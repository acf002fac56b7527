"""Public wrappers of the VMSP support-join kernels.

The port's counterpart of ``src/repro/kernels/bitmap_support/ops.py``.
Words are ``int32`` tensors holding the miner's ``uint32`` bitmaps.

* On CPU tensors a wrapper runs the plain version in :mod:`.ref`.
* On CUDA tensors it launches the hand-written kernel of
  ``csrc/bitmap_support.cu`` (built at first use) or raises.  It never
  falls back.

``counts`` holds the kernel launches since the last reset: a wrapper adds
one where it launches its kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from .. import _build
from . import ref

__all__ = ["frontier_join_support", "sstep_join_support", "counts",
           "load"]

_SOURCES = (Path(__file__).resolve().parent / "csrc" / "bitmap_support.cu",)
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # slots, cand, support, P, K, S, W, splits, device, stream
    "frontier_join_support_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # slots, cand, joined, support, K, S, W, device, stream
    "sstep_join_support_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
}
_TILE = 32              # prefixes and items per block of the frontier kernel
_MIN_SPLIT_SESSIONS = 512
_SSTEP_SESSIONS_PER_BLOCK = 1024   # kSessionsPerBlock of the s-step kernel
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


def _on_cpu(*ts: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU; raises unless all lie on
    one CUDA device otherwise."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    dev = next(iter(devs))
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def _launch_args(t: torch.Tensor) -> tuple[int, int]:
    dev = t.device.index if t.device.index is not None else \
        torch.cuda.current_device()
    return dev, torch.cuda.current_stream(dev).cuda_stream


def _splits(p_prefixes: int, k_items: int, n_sessions: int,
            device: int) -> int:
    """Session splits that bring the frontier grid to ~2 blocks per SM."""
    tiles = math.ceil(p_prefixes / _TILE) * math.ceil(k_items / _TILE)
    want = 2 * torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(math.ceil(want / tiles),
                      n_sessions // _MIN_SPLIT_SESSIONS))


def frontier_join_support(slots: torch.Tensor,
                          cand: torch.Tensor) -> torch.Tensor:
    """(P, S, W) × (K, S, W) int32 -> support (P, K) int32: the number of
    sessions where ``slots[p] & cand[k]`` has a nonzero word."""
    _check("slots", slots, 3)
    _check("cand", cand, 3)
    p_prefixes, n_sessions, n_words = slots.shape
    k_items = cand.shape[0]
    if cand.shape[1:] != slots.shape[1:]:
        raise ValueError(f"cand {tuple(cand.shape)} does not match "
                         f"slots {tuple(slots.shape)}")
    if _on_cpu(slots, cand):
        return ref.frontier_join_support(slots, cand)
    if min(p_prefixes, k_items, n_sessions, n_words) == 0:
        return torch.zeros((p_prefixes, k_items), dtype=torch.int32,
                           device=slots.device)
    if max(p_prefixes, k_items, n_sessions * n_words) > _INT_MAX:
        raise ValueError("frontier too large for 32-bit indices")
    dev, stream = _launch_args(slots)
    splits = _splits(p_prefixes, k_items, n_sessions, dev)
    alloc = torch.zeros if splits > 1 else torch.empty
    support = alloc((p_prefixes, k_items), dtype=torch.int32,
                    device=slots.device)
    err = load().frontier_join_support_launch(
        slots.data_ptr(), cand.data_ptr(), support.data_ptr(),
        p_prefixes, k_items, n_sessions, n_words, splits, dev, stream)
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
    if _on_cpu(slots, cand):
        return ref.sstep_join_support(slots, cand)
    support = torch.zeros((k_items,), dtype=torch.int32, device=cand.device)
    joined = torch.empty_like(cand)
    if min(k_items, n_sessions, n_words) == 0:
        return joined, support
    if max(k_items * math.ceil(n_sessions / _SSTEP_SESSIONS_PER_BLOCK),
           n_sessions * n_words) > _INT_MAX:
        raise ValueError("join too large for 32-bit indices")
    dev, stream = _launch_args(cand)
    err = load().sstep_join_support_launch(
        slots.data_ptr(), cand.data_ptr(), joined.data_ptr(),
        support.data_ptr(), k_items, n_sessions, n_words, dev, stream)
    if err:
        raise RuntimeError(f"sstep_join_support launch failed: "
                           f"CUDA error {err}")
    counts["sstep_join_support"] += 1
    return joined, support
