"""Public wrapper of the flash-attention kernel.

The port's counterpart of ``src/repro/kernels/flash_attention/ops.py``.

* On CPU tensors it runs the plain version in :mod:`.ref`.
* On CUDA tensors it launches the hand-written kernel of
  ``csrc/flash_attention.cu`` (built at first use) or raises.  It never
  falls back.

The kernel takes each tensor's (batch, head, position) strides and needs
only the head_dim to be contiguous, so a transposed view of the model's
(B, S, H, D) activations goes in without a copy; its result is a
(B, Hq, Lq, D) view of a (B, Lq, Hq, D) buffer, which the model turns
back into (B, S, H, D) for free.  Masking of ragged lengths happens in
the kernel: nothing is padded.

``counts`` holds the kernel launches since the last reset: the wrapper
adds one where it launches its kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from .. import _build
from .._launch import launch_args, on_cpu
from . import ref

__all__ = ["flash_attention", "counts", "load", "HEAD_DIMS"]

_SOURCES = (Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # q, k, v, out, dtype, B, Hq, Hkv, Lq, Lk, D, causal, sm_scale,
    # (batch, head, position) strides of q, k, v and out, device, stream
    "flash_attention_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _I, ctypes.c_float, *[_L] * 12, _I, _P],
}
#: head_dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BLOCK_Q = 64             # q rows per block (kBlockQ)
_MAX_Q_TILES = 65_535     # the grid's y limit
_INT_MAX = 2 ** 31 - 1

#: kernel launches since the last reset
counts = {"flash_attention": 0}


def load() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library."""
    return _build.load_library("flash_attention", _SOURCES, _SIGNATURES)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, "
                            f"got {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, H, L, D), got "
                             f"{t.dim()} dims")
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name} must have a contiguous head_dim")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    b, hq, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} does not match "
                         f"q {tuple(q.shape)}")
    if k.shape[1] == 0 or hq % k.shape[1]:
        raise ValueError(f"q heads {hq} are not a multiple of kv heads "
                         f"{k.shape[1]}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} is not one of {HEAD_DIMS}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Hq, Lq, D), k/v (B, Hkv, Lk, D) -> (B, Hq, Lq, D) in q's dtype.

    Forward GQA attention with f32 accumulation and an end-aligned causal
    mask (row r sees columns <= r + Lk - Lq); a row that sees no column
    gives 0.  ``sm_scale`` defaults to ``D ** -0.5``.  float32 or bfloat16;
    head_dim one of :data:`HEAD_DIMS`."""
    _check(q, k, v)
    if on_cpu(q, k, v):
        return ref.flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = d ** -0.5
    out = torch.empty((b, lq, hq, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    if lk == 0:                 # every row sees nothing
        return out.zero_()
    if b * hq > _INT_MAX or -(-lq // _BLOCK_Q) > _MAX_Q_TILES:
        raise ValueError(f"q {tuple(q.shape)} exceeds the kernel's grid")
    dev, stream = launch_args(q)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    err = load().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], b, hq, hkv, lq, lk, d, int(causal),
        float(sm_scale), *strides, dev, stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    counts["flash_attention"] += 1
    return out
