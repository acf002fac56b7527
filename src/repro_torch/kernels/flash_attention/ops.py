"""Public wrapper of the flash-attention kernels.

The port's counterpart of ``src/repro/kernels/flash_attention/ops.py``.

* On CPU tensors it runs the plain version in :mod:`.ref`.
* On CUDA tensors it launches the hand-written kernel of its route, built
  at first use, or raises.  It never falls back: not to the other route,
  not to the plain version.

Two kernels compute the same function, and :func:`route` names which one
a call takes from its dtype and head_dim alone:

* ``"tensor_core"``: bfloat16 at head_dim 64 or 128 (every dense and GQA
  config of the repo), ``csrc/flash_attention_wgmma.cu``: ``wgmma`` on
  the tensor cores, TMA loads.  It reads its inputs through TMA tensor
  maps, so each base must be 16-byte aligned and each stride a positive
  multiple of 16 bytes; the wrapper raises ``ValueError`` otherwise.
* ``"tf32x3"``: float32 at every head_dim, and bfloat16 at every head_dim
  but 64 and 128, ``csrc/flash_attention_tf32x3.cu``: ``mma.sync`` on the
  tensor cores in split TF32, each f32 operand split into a TF32 high and
  low part and each product the sum of three TF32 products, which keeps
  f32 accuracy (a bfloat16 operand is exact in TF32 and is not split).  It
  takes any base and strides, copying 16 bytes at a time where they allow.
  It is instantiated at the head_dims of :data:`HEAD_DIMS`; a head_dim
  between them runs on a zero-padded copy of q, k and v (zero columns add
  nothing to q.k and give zero output columns), and one past
  :data:`MAX_HEAD_DIM` raises ``ValueError`` on a card.

Each kernel takes its tensors' (batch, head, position) strides and needs
only the head_dim to be contiguous, so a transposed view of the model's
(B, S, H, D) activations goes in without a copy; the result is a
(B, Hq, Lq, D) view of a (B, Lq, Hq, D) buffer, which the model turns
back into (B, S, H, D) for free.  Masking of ragged lengths happens in
the kernels: no length is padded.

``counts`` holds the kernel launches since the last reset: the wrapper
adds one to ``"flash_attention"`` and one to its route's count where it
launches a kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from .. import _build
from .._launch import launch_args, on_cpu
from . import ref

__all__ = ["flash_attention", "counts", "load", "route", "kernel_head_dim",
           "HEAD_DIMS", "MAX_HEAD_DIM", "ROUTES"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: q, k, v and out's (batch, head, position) strides, device, stream
_TAIL = [*[_L] * 12, _I, _P]
#: route -> (library, sources, its C functions' argument types)
_LIBRARIES = {
    "tf32x3": ("flash_attention_tf32x3",
               (_CSRC / "flash_attention_tf32x3.cu",), {
        # q, k, v, out, dtype, B, Hq, Hkv, Lq, Lk, D, causal, sm_scale, ...
        "flash_attention_tf32x3_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                          _I, _I, _I, ctypes.c_float,
                                          *_TAIL]}),
    "tensor_core": ("flash_attention_wgmma",
                    (_CSRC / "flash_attention_wgmma.cu",), {
        # q, k, v, out, B, Hq, Hkv, Lq, Lk, D, causal, sm_scale, ...
        "flash_attention_wgmma_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                         _I, _I, ctypes.c_float, *_TAIL],
        # D -> dynamic shared memory of a block, in bytes
        "flash_attention_wgmma_smem_bytes": [_I]}),
}
ROUTES = tuple(_LIBRARIES)
#: head_dims the split-TF32 kernel is instantiated for, in both dtypes:
#: its QK^T reads 16 head_dim columns at a time
HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)
MAX_HEAD_DIM = HEAD_DIMS[-1]
_TENSOR_CORE_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BLOCK_Q = {"tf32x3": 64, "tensor_core": 128}   # q rows per block
_INT_MAX = 2 ** 31 - 1    # a grid's x limit
_TMA_ALIGN = 16           # bytes, of a TMA tensor map's base and strides

#: kernel launches since the last reset: the total and each route's
counts = {"flash_attention": 0, "tensor_core": 0, "tf32x3": 0}


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a call with these inputs launches on a card:
    ``"tensor_core"`` for bfloat16 at head_dim 64 or 128, else
    ``"tf32x3"``."""
    if dtype == torch.bfloat16 and head_dim in _TENSOR_CORE_DIMS:
        return "tensor_core"
    return "tf32x3"


def load(which: str = "tensor_core") -> ctypes.CDLL:
    """Build (at first use) and load the library of route ``which``."""
    name, sources, signatures = _LIBRARIES[which]
    return _build.load_library(name, sources, signatures)


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
    if route(q.dtype, d) == "tensor_core":
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % _TMA_ALIGN:
                raise ValueError(f"{name}'s data is not {_TMA_ALIGN}-byte "
                                 f"aligned, as the tensor-core kernel's TMA "
                                 f"loads need")
            step = _TMA_ALIGN // t.element_size()
            if any(t.stride(i) <= 0 or t.stride(i) % step
                   for i in range(3) if t.shape[i] > 1):
                raise ValueError(f"{name}'s strides {t.stride()} are not "
                                 f"positive multiples of {_TMA_ALIGN} bytes, "
                                 f"as the tensor-core kernel's TMA loads "
                                 f"need")


def kernel_head_dim(d: int) -> int:
    """The head_dim of the kernel a call of head_dim ``d`` launches: ``d``
    rounded up to a multiple of 16.  Raises ``ValueError`` outside 1 to
    :data:`MAX_HEAD_DIM`."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} is outside the kernels' 1 to "
                         f"{MAX_HEAD_DIM}")
    return -(-d // 16) * 16


def _check_grid(which: str, b: int, hq: int, lq: int) -> None:
    """Raise ``ValueError`` where route ``which``'s grid cannot hold the
    call: each route's grid is 1-D over (B * Hq) x q tiles of
    ``_BLOCK_Q[which]`` rows."""
    if b * hq * -(-lq // _BLOCK_Q[which]) > _INT_MAX:
        raise ValueError(f"q ({b}, {hq}, {lq}, D) exceeds the {which} "
                         f"kernel's grid")


def _strides(t: torch.Tensor) -> list[int]:
    """(batch, head, position) strides; a dim of size 1 is never stepped
    over, so it gets the head_dim, which any kernel takes."""
    return [s if n > 1 else t.shape[3] for n, s in zip(t.shape[:3],
                                                        t.stride()[:3])]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Hq, Lq, D), k/v (B, Hkv, Lk, D) -> (B, Hq, Lq, D) in q's dtype.

    Forward GQA attention with f32 scores and accumulation and an
    end-aligned causal mask (row r sees columns <= r + Lk - Lq); a row that
    sees no column gives 0.  ``sm_scale`` defaults to ``D ** -0.5``.
    float32 or bfloat16; any head_dim on the CPU, 1 to
    :data:`MAX_HEAD_DIM` on a card."""
    _check(q, k, v)
    if on_cpu(q, k, v):
        return ref.flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    which = route(q.dtype, d)
    dk = kernel_head_dim(d)
    if sm_scale is None:
        sm_scale = d ** -0.5    # the true head_dim's, not the padded one
    out = torch.empty((b, lq, hq, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    if lk == 0:                 # every row sees nothing
        return out.zero_()
    _check_grid(which, b, hq, lq)
    res = out
    if dk != d:                 # the split-TF32 route only
        q, k, v = (torch.nn.functional.pad(t, (0, dk - d)) for t in (q, k, v))
        res = torch.empty((b, lq, hq, dk), dtype=q.dtype,
                          device=q.device).transpose(1, 2)
    dev, stream = launch_args(q)
    if which == "tensor_core" and sm_scale <= 0:
        # the kernel folds a positive scale into its exp2; the same scores
        # come from (sign * q) . k * |scale|, and a zero scale from q = 0
        q = q.neg() if sm_scale < 0 else torch.zeros_like(q)
        sm_scale = -sm_scale if sm_scale < 0 else 1.0
    ptrs = [t.data_ptr() for t in (q, k, v, res)]
    rest = [b, hq, hkv, lq, lk, dk, int(causal), float(sm_scale),
            *(s for t in (q, k, v, res) for s in _strides(t)), dev, stream]
    if which == "tf32x3":
        err = load(which).flash_attention_tf32x3_launch(
            *ptrs, _DTYPES[q.dtype], *rest)
    else:
        err = load(which).flash_attention_wgmma_launch(*ptrs, *rest)
    if err:
        raise RuntimeError(f"flash_attention ({which}) launch failed: "
                           f"{_describe(err)}")
    counts["flash_attention"] += 1
    counts[which] += 1
    if res is not out:
        out.copy_(res[..., :d])
    return out


def _describe(err: int) -> str:
    if err >= 10000:
        return f"cuTensorMapEncodeTiled returned CUresult {err - 10000}"
    return f"CUDA error {err}"
