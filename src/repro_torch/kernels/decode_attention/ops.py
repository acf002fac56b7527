"""Public wrapper of the decode-attention kernel.

The kernel (``csrc/decode_attention.cu``) replaces no TPU kernel: the JAX
package decodes through its plain ``_reference_attention``.  It computes
the same function for one query position over a KV cache's valid prefix
(:func:`.ref.decode_attention`), reading the cache once in its own dtype,
which is the one thing decode attention's time depends on.

* On CPU tensors it runs the plain version in :mod:`.ref`.
* On CUDA tensors it launches the kernel, built at first use, or raises.
  It never falls back to the plain version.

A call checks its inputs on every device: float32 or bfloat16, q, k and v
alike; q (B, 1, Hq, D), k and v (B, Lmax, Hkv, D) with Hkv dividing Hq; a
head_dim that is a multiple of 16 up to 256 and contiguous; k's and v's
bases and (batch, position, head) strides in whole 16 bytes, so that the
kernel's 16-byte copies read a layer's view of the stacked cache in
place; and ``1 <= valid <= Lmax``.  It raises ``ValueError`` otherwise.

The kernel splits the valid positions into :func:`plan`'s splits where the
(batch row, kv head) blocks alone leave SMs idle; each split's (max, sum,
accumulator) is then merged by a second small kernel, in split order.

``counts`` holds the launches since the last reset: one in
``"decode_attention"`` a call, and one in ``"merge"`` where the call took
more than one split.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
import torch

from .. import _build
from .._launch import launch_args, on_cpu
from . import ref

__all__ = ["decode_attention", "counts", "load", "plan", "head_chunks",
           "MAX_HEAD_DIM", "MAX_HEADS", "MIN_SPLIT_ROWS"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # q, k, v, out, part_o, part_ml, dtype, B, Hq, Hkv, D, valid, splits,
    # chunk_rows, sm_scale, q's (batch, head) strides, k's and v's
    # (batch, position, head) strides, device, stream
    "decode_attention_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _I, _I, _I, ctypes.c_float, *[_L] * 8, _I,
                                _P]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the largest head_dim the kernel takes (8 columns a lane, 32 lanes)
MAX_HEAD_DIM = 256
#: q heads a block holds; a larger GQA group takes more blocks
MAX_HEADS = 16
#: positions a split takes at least, so that a split's block has work to
#: hide its start behind
MIN_SPLIT_ROWS = 256
_INT_MAX = 2 ** 31 - 1    # a grid's x limit
_ALIGN = 16               # bytes, of the kernel's copies

#: launches since the last reset: one a call, and the merge's
counts = {"decode_attention": 0, "merge": 0}

def load() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library."""
    return _build.load_library("decode_attention",
                               (_CSRC / "decode_attention.cu",), _SIGNATURES)


def head_chunks(group: int) -> int:
    """Blocks a (batch row, kv head) takes for a GQA group of ``group`` q
    heads: one per :data:`MAX_HEADS` of them."""
    return -(-group // MAX_HEADS)


def plan(blocks: int, valid: int, n_sm: int) -> tuple[int, int]:
    """(splits, rows a split) for ``blocks`` blocks a split (batch rows x
    kv heads x :func:`head_chunks`) over ``valid`` positions on a card of
    ``n_sm`` SMs.  One split where the blocks already fill the SMs; else
    enough for about two blocks an SM, each of at least
    :data:`MIN_SPLIT_ROWS` positions.  Split s covers positions
    ``[s * rows, min((s + 1) * rows, valid))``; none is empty."""
    if blocks >= n_sm:
        return 1, valid
    splits = max(1, min(-(-2 * n_sm // blocks), valid // MIN_SPLIT_ROWS))
    rows = -(-valid // splits)
    return -(-valid // rows), rows


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           valid: int) -> None:
    # a decode step calls this once a layer: one pass, few calls
    dtype = q.dtype
    if dtype not in _DTYPES or k.dtype != dtype or v.dtype != dtype:
        raise ValueError(f"q, k, v must be float32 or bfloat16 alike, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)} must be (B, 1, Hq, D), k "
                         f"{tuple(k.shape)} and v {tuple(v.shape)} the same "
                         f"(B, Lmax, Hkv, D)")
    b, sq, hq, d = q.shape
    kb, lmax, hkv, kd = k.shape
    if sq != 1 or kb != b or kd != d or hkv == 0 or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} is not one position of q "
                         f"heads that are a multiple of k "
                         f"{tuple(k.shape)}'s kv heads")
    if d % 16 or not 16 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} is not a multiple of 16 from 16 to "
                         f"{MAX_HEAD_DIM}")
    if not 1 <= valid <= lmax:
        raise ValueError(f"valid {valid} is not in [1, {lmax}]")
    if q.stride(3) != 1:
        raise ValueError("q must have a contiguous head_dim")
    step = _ALIGN // k.element_size()
    for name, t in (("k", k), ("v", v)):
        sb, sp, sh, sd = t.stride()
        if sd != 1 or t.data_ptr() % _ALIGN or any(
                n > 1 and (st <= 0 or st % step)
                for n, st in ((b, sb), (lmax, sp), (hkv, sh))):
            raise ValueError(f"{name}'s base or strides {t.stride()} are not "
                             f"in whole {_ALIGN} bytes with a contiguous "
                             f"head_dim, as the kernel's copies need")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: int) -> torch.Tensor:
    """q (B, 1, Hq, D), k/v (B, Lmax, Hkv, D) -> (B, 1, Hq, D) in q's
    dtype: q head h attends over positions ``[0, valid)`` of kv head
    ``h // (Hq / Hkv)`` with f32 scores (scaled by ``D ** -0.5``),
    softmax and accumulation.  Raises ``ValueError`` on
    inputs the kernel does not take (module docstring), and
    ``NotImplementedError`` where autograd would record the call: the
    kernel has no backward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "the decode-attention kernel has no backward: decode under "
            "torch.no_grad()")
    _check(q, k, v, valid)
    if on_cpu(q, k, v):
        return ref.decode_attention(q, k, v, valid)
    b, _, hq, d = q.shape
    hkv = k.shape[2]
    dev, stream = launch_args(q)
    blocks = b * hkv * head_chunks(hq // hkv)
    splits, rows = plan(blocks, valid, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    if blocks * splits > _INT_MAX:
        raise ValueError(f"q {tuple(q.shape)} over {splits} splits exceeds "
                         f"the kernel's grid")
    out = torch.empty((b, 1, hq, d), dtype=q.dtype, device=q.device)
    part_o = part_ml = None
    if splits > 1:
        # the splits' accumulators (B, Hq, splits, D), then their (max,
        # sum) pairs (B, Hq, splits, 2), in one f32 buffer
        part = torch.empty(b * hq * splits * (d + 2), dtype=torch.float32,
                           device=q.device)
        part_o = part.data_ptr()
        part_ml = part_o + b * hq * splits * d * part.element_size()
    err = load().decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), part_o,
        part_ml, _DTYPES[q.dtype], b, hq, hkv, d, valid, splits, rows,
        d ** -0.5, q.stride(0), q.stride(2), k.stride(0), k.stride(1),
        k.stride(2), v.stride(0), v.stride(1), v.stride(2), dev, stream)
    if err:
        raise RuntimeError(f"decode_attention launch failed: CUDA error "
                           f"{err}")
    counts["decode_attention"] += 1
    if splits > 1:
        counts["merge"] += 1
    return out
