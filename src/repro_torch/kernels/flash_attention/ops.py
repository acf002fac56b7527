"""Public wrapper of the flash-attention kernels.

The port's counterpart of ``src/repro/kernels/flash_attention/ops.py``.

* On CPU tensors it runs the plain version in :mod:`.ref`.
* On CUDA tensors it launches the hand-written kernel of its route, built
  at first use, or raises.  It never falls back: not to the other route,
  not to the plain version.

Two kernels compute the same function, and :func:`route` names which one
a call takes from its dtype alone:

* ``"tensor_core"``: bfloat16 at every head_dim (every config of the
  repo: 64 and 128 for the dense, GQA, vlm, audio and moe ones, 112 for
  zamba2-7b's shared attention), ``csrc/flash_attention_wgmma.cu``:
  ``wgmma`` on the tensor cores, TMA loads, instantiated at the head_dims
  of :data:`TENSOR_CORE_HEAD_DIMS` and, past them, a wide kernel that
  takes the head_dim at run time.  It reads its inputs through TMA tensor
  maps, so each base must be 16-byte aligned and each stride a positive
  multiple of 16 bytes.  At head_dim 64 and 128 the wrapper raises
  ``ValueError`` for anything else, on any device, as it has since the
  route took only those two; at the others such an input goes in as an
  aligned copy on a card (the CPU runs the plain version on it).
* ``"tf32x3"``: float32 at every head_dim,
  ``csrc/flash_attention_tf32x3.cu``: ``mma.sync`` on the tensor cores in
  split TF32, each f32 operand split into a TF32 high and low part and
  each product the sum of three TF32 products, which keeps f32 accuracy.
  It takes any base and strides, copying 16 bytes at a time where they
  allow.  It is instantiated at the head_dims of :data:`HEAD_DIMS` and,
  past them, a wide kernel that takes the head_dim at run time.

Past head_dim 128, on either route, a block owns a q tile and every
output column up to head_dim 512 (:func:`out_chunks`), and computes q.k
once a kv tile.  Up to 256 one warpgroup (tensor cores) or each warp of
16 rows (split TF32) holds all of them; past 256 the warpgroups or warps
of a row group each own 128 of the output's columns and the same 128 of
q.k's head_dim, and add their partial scores through shared memory in a
fixed order.  Past 512 the output's columns no longer fit a block's
registers, so they are cut into chunks of at most 384, one a block, and
each block reads q.k's head_dim in rounds: shared memory bounds no
head_dim, and only the grid can refuse a call (:func:`_check_grid`).
Each library keeps its own copy of that rule and reports its count of
blocks a q tile (``flash_attention_*_chunks``), which a card test holds
to :func:`out_chunks`.  The kernels past 128 count the products they
issue (:func:`counted_products`).  On the tensor cores a kv tile's P.V is
summed from zero and added to O in f32 at every head_dim, as the
reference adds each tile's f32 product into its accumulator.

On either route a head_dim that is not a multiple of 16 runs on copies of
q, k and v zero-padded to the next one (:func:`kernel_head_dim`): zero
columns add nothing to q.k and give zero output columns, which the
wrapper cuts off; the scale stays the true head_dim's.

Each kernel takes its tensors' (batch, head, position) strides and needs
only the head_dim to be contiguous, so a transposed view of the model's
(B, S, H, D) activations goes in without a copy; the result is a
(B, Hq, Lq, D) view of a (B, Lq, Hq, D) buffer, which the model turns
back into (B, S, H, D) for free.  Masking of ragged lengths happens in
the kernels: no length is padded.

Neither kernel has a backward, as the reference's Pallas kernel has none
(``jax.grad`` through it fails): where autograd would record the call
(grad enabled and q, k or v requiring grad) the wrapper raises
``NotImplementedError`` on every device, rather than return an output
without a gradient.  Training takes ``attention_impl="reference"`` or
``"blocked"``.

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

__all__ = ["flash_attention", "counts", "counted_products", "load", "route",
           "kernel_head_dim", "out_chunks", "HEAD_DIMS", "ROUTES",
           "TENSOR_CORE_HEAD_DIMS"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: q, k, v and out's (batch, head, position) strides, device, stream
_TAIL = [*[_L] * 12, _I, _P]
#: route -> (library, sources, its C functions' argument types, its own
#: nvcc flags): split TF32's front end optimizes in threads (its 16 float32
#: kernels at head_dim 144-256 hold all of O; built whole, one thread takes
#: a minute); the tensor-core library builds without the flag, which
#: changes its SASS
_LIBRARIES = {
    "tf32x3": ("flash_attention_tf32x3",
               (_CSRC / "flash_attention_tf32x3.cu",), {
        # q, k, v, out, dtype, B, Hq, Hkv, Lq, Lk, D, causal, sm_scale, ...
        "flash_attention_tf32x3_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                          _I, _I, _I, ctypes.c_float,
                                          *_TAIL],
        # flop[2], reset, device: the products counted past head_dim 128
        "flash_attention_tf32x3_products": [_P, _I, _I],
        # D -> blocks a q tile
        "flash_attention_tf32x3_chunks": [_I]}, ("--split-compile=0",)),
    "tensor_core": ("flash_attention_wgmma",
                    (_CSRC / "flash_attention_wgmma.cu",), {
        # q, k, v, out, B, Hq, Hkv, Lq, Lk, D, p_parts, causal, sm_scale, ...
        "flash_attention_wgmma_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                         _I, _I, _I, ctypes.c_float, *_TAIL],
        # D -> dynamic shared memory of a block, in bytes
        "flash_attention_wgmma_smem_bytes": [_I],
        "flash_attention_wgmma_products": [_P, _I, _I],
        "flash_attention_wgmma_chunks": [_I]}, ()),
}
ROUTES = tuple(_LIBRARIES)
#: head_dims the split-TF32 kernel is instantiated for (its QK^T reads 16
#: head_dim columns at a time); past them its wide kernel takes any
#: multiple of 16 in float32
HEAD_DIMS = tuple(range(16, 257, 16))
_WHOLE_D = 512            # head_dims whose output columns one block holds
_CHUNK_COLUMNS = 384      # most output columns a block holds past them
#: head_dims the tensor-core kernel is instantiated for, in bfloat16 (its
#: QK^T reads 16 head_dim columns at a time, its P.V writes 64 or fewer);
#: past them its wide kernel takes any multiple of 16
TENSOR_CORE_HEAD_DIMS = tuple(range(16, 129, 16))
#: head_dims at which the tensor-core route refuses a view TMA cannot
#: read in place (the two it took before it took every one up to 128)
_TMA_REFUSED_DIMS = (64, 128)
#: bf16 parts the tensor-core kernel splits f32 p into for P.V (1 to 3):
#: three carry all of f32's 24 bits, so its output rounds like the plain
#: version's f32 attention; fewer are faster and drift further
P_PARTS = 3
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2 ** 31 - 1    # a grid's x limit
_TMA_ALIGN = 16           # bytes, of a TMA tensor map's base and strides

#: kernel launches since the last reset: the total and each route's
counts = {"flash_attention": 0, "tensor_core": 0, "tf32x3": 0}


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a call with these inputs launches on a card:
    ``"tensor_core"`` for bfloat16 at every head_dim from 1, else
    ``"tf32x3"``."""
    if dtype == torch.bfloat16 and head_dim >= 1:
        return "tensor_core"
    return "tf32x3"


def load(which: str = "tensor_core") -> ctypes.CDLL:
    """Build (at first use) and load the library of route ``which``."""
    name, sources, signatures, flags = _LIBRARIES[which]
    return _build.load_library(name, sources, signatures, flags)


def counted_products(which: str, device: Optional[int] = None,
                     reset: bool = False) -> tuple[int, int]:
    """The FLOP of q.k products and of P.V products that route ``which``'s
    kernels past head_dim 128 have issued on card ``device`` (the current
    one by default) since the last reset, as the kernels count them (the
    kernels up to 128 count none): split TF32's warps where they issue
    each product, the tensor cores' warpgroups as the tiles they ran times
    the products their loop body issues a tile.  Whole tiles count, masked
    columns included; a split-TF32 product counts as its three TF32 ones.
    ``reset`` zeroes the counts after reading them.  Waits for the card's
    work first."""
    dev = torch.cuda.current_device() if device is None else device
    torch.cuda.synchronize(dev)
    flop = (ctypes.c_longlong * 2)()
    lib = load(which)
    read = (lib.flash_attention_tf32x3_products if which == "tf32x3"
            else lib.flash_attention_wgmma_products)
    err = read(ctypes.addressof(flop), int(reset), dev)
    if err:
        raise RuntimeError(f"reading the {which} kernels' product counts "
                           f"failed: {_describe(err)}")
    return flop[0], flop[1]


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
    if route(q.dtype, d) == "tensor_core" and d in _TMA_REFUSED_DIMS:
        for name, t in (("q", q), ("k", k), ("v", v)):
            fault = _tma_fault(name, t)
            if fault:
                raise ValueError(fault)


def _tma_fault(name: str, t: torch.Tensor) -> Optional[str]:
    """Why the tensor-core kernel's TMA loads cannot read ``t`` in place,
    or ``None`` where they can."""
    if t.data_ptr() % _TMA_ALIGN:
        return (f"{name}'s data is not {_TMA_ALIGN}-byte aligned, as the "
                f"tensor-core kernel's TMA loads need")
    step = _TMA_ALIGN // t.element_size()
    if any(t.stride(i) <= 0 or t.stride(i) % step
           for i in range(3) if t.shape[i] > 1):
        return (f"{name}'s strides {t.stride()} are not positive multiples "
                f"of {_TMA_ALIGN} bytes, as the tensor-core kernel's TMA "
                f"loads need")
    return None


def kernel_head_dim(d: int) -> int:
    """The head_dim of the kernel a call of head_dim ``d`` launches: ``d``
    rounded up to a multiple of 16.  Raises ``ValueError`` below 1."""
    if d < 1:
        raise ValueError(f"head_dim {d} is below 1")
    return -(-d // 16) * 16


def _chunk_columns(d: int) -> int:
    """Output columns a block of either route holds at kernel head_dim
    ``d`` past 128 (the last block of a row may hold fewer): all of ``d``
    up to 512; past it an equal share of at most 384, rounded up to a
    multiple of 64."""
    if d <= _WHOLE_D:
        return d
    share = -(-d // -(-d // _CHUNK_COLUMNS))
    return -(-share // 64) * 64


def out_chunks(d: int) -> int:
    """The blocks either route gives a q tile at kernel head_dim ``d``,
    each holding a chunk of the output's columns: 1 up to 512, where a
    block holds them all; past it ``ceil(d / _chunk_columns(d))``, each
    chunk but the last holding ``_chunk_columns(d)`` columns (320 or 384)
    and computing q.k over the whole head_dim."""
    return -(-d // _chunk_columns(d))


def _block_q(which: str, d: int) -> int:
    """q rows a block of route ``which`` holds at kernel head_dim ``d``:
    the tensor-core kernel 128 up to 128 and 64 past it (one warpgroup's
    rows); the split-TF32 kernel 64 up to 256 (its instantiations) and 32
    past it (its wide kernel, so that q, K and V fit shared memory)."""
    if which == "tensor_core":
        return 128 if d <= 128 else 64
    return 64 if d <= 256 else 32


def _block_kv(which: str, d: int) -> int:
    """kv rows a tile of route ``which``'s kernel at kernel head_dim ``d``:
    the tensor-core kernel 128 up to 128 (``kBlock``) and 64 past it
    (``kWideRows``); the split-TF32 kernel 64 up to 64, then 32
    (``Tile::kBlockK``, ``kWideBlockK``)."""
    if which == "tensor_core":
        return 128 if d <= 128 else 64
    return 64 if d <= 64 else 32


def _tile_pairs(which: str, d: int, lq: int, lk: int) -> int:
    """The (q tile, kv tile) pairs route ``which``'s kernel runs for one
    (batch, head) of a causal call at kernel head_dim ``d``: each q tile
    of ``_block_q`` rows takes the kv tiles of ``_block_kv`` rows up to
    the last one its last row sees (the mask is aligned to the end of the
    kv sequence)."""
    bq, bk = _block_q(which, d), _block_kv(which, d)
    pairs = 0
    for q0 in range(0, lq, bq):
        last = min(q0 + bq, lq) - 1 + lk - lq
        pairs += 0 if last < 0 else min(-(-lk // bk), last // bk + 1)
    return pairs


def _check_grid(which: str, b: int, hq: int, lq: int, d: int) -> None:
    """Raise ``ValueError`` where route ``which``'s grid cannot hold the
    call at kernel head_dim ``d``: each route's grid is 1-D over
    (B * Hq) x q tiles of ``_block_q(which, d)`` rows x ``out_chunks(d)``."""
    if b * hq * -(-lq // _block_q(which, d)) * out_chunks(d) > _INT_MAX:
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
    float32 or bfloat16; any head_dim, on the CPU and on a card.  Raises
    ``NotImplementedError`` where autograd would record the call: the
    kernels have no backward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "the flash kernels have no backward, as in the JAX package: "
            "train with attention_impl='reference' or 'blocked', or call "
            "under torch.no_grad()")
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
    _check_grid(which, b, hq, lq, dk)
    res = out
    if dk != d:                 # either route: zero-padded copies
        q, k, v = (torch.nn.functional.pad(t, (0, dk - d)) for t in (q, k, v))
        res = torch.empty((b, lq, hq, dk), dtype=q.dtype,
                          device=q.device).transpose(1, 2)
    if which == "tensor_core":
        # what TMA cannot read in place (at a head_dim _check lets through)
        # goes in as a contiguous, aligned copy
        q, k, v = (t if _tma_fault("", t) is None
                   else t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v))
    dev, stream = launch_args(q)
    if which == "tensor_core" and sm_scale <= 0:
        # the kernel folds a positive scale into its exp2; the same scores
        # come from (sign * q) . k * |scale|, and a zero scale from q = 0
        q = q.neg() if sm_scale < 0 else torch.zeros_like(q)
        sm_scale = -sm_scale if sm_scale < 0 else 1.0
    ptrs = [t.data_ptr() for t in (q, k, v, res)]
    dims = [b, hq, hkv, lq, lk, dk]
    rest = [int(causal), float(sm_scale),
            *(s for t in (q, k, v, res) for s in _strides(t)), dev, stream]
    if which == "tf32x3":
        err = load(which).flash_attention_tf32x3_launch(
            *ptrs, _DTYPES[q.dtype], *dims, *rest)
    else:
        err = load(which).flash_attention_wgmma_launch(
            *ptrs, *dims, P_PARTS, *rest)
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
