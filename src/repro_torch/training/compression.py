"""Int8 gradient compression for cross-pod reductions.

The port of ``src/repro/training/compression.py``: per-block (blocks of
256 of the flattened tensor) symmetric int8 quantization with f32 scales,
rounded half to even as ``jnp.round``.  The reference's pytrees are
nested dicts of tensors here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["compress_tree", "decompress_tree", "compress", "decompress"]

_BLOCK = 256


def compress(x: torch.Tensor) -> dict:
    """x: any-shape float -> {int8 codes, f32 scales, shape, pad}."""
    shape = tuple(x.shape)
    flat = x.float().reshape(-1)
    pad = (-flat.numel()) % _BLOCK
    blocks = F.pad(flat, (0, pad)).reshape(-1, _BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    safe = torch.where(scale == 0, 1.0, scale)
    codes = torch.clamp(torch.round(blocks / safe), -127, 127).to(torch.int8)
    return {"codes": codes, "scale": scale, "shape": shape, "pad": pad}


def decompress(c: dict) -> torch.Tensor:
    flat = (c["codes"].float() * c["scale"]).reshape(-1)
    return flat[:flat.numel() - c["pad"]].reshape(c["shape"])


def compress_tree(tree):
    if isinstance(tree, torch.Tensor):
        return compress(tree)
    return {k: compress_tree(v) for k, v in tree.items()}


def decompress_tree(tree):
    if "codes" in tree:
        return decompress(tree)
    return {k: decompress_tree(v) for k, v in tree.items()}
