"""Batch construction: real tensors for the examples and tests, and
shape-and-dtype records (``input_specs``) for the dry-run.

The port of ``src/repro/models/io.py``: ``make_batch`` makes the same
numpy draws from ``default_rng(seed)``, so one seed gives the same tokens
in both packages; ``batch_specs``, ``cache_specs`` and ``input_specs``
return :class:`~repro_torch.models.transformer.TensorSpec` records where
the reference returns ``jax.ShapeDtypeStruct``s, the cache's from
``init_cache`` on the ``meta`` device.  :func:`place_cache` places a
decode cache on a mesh by ``rules.cache_pspec``, for a tensor-parallel
model's ``prefill`` and ``decode_step``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from . import transformer
from .transformer import TensorSpec

__all__ = ["make_batch", "text_len", "input_specs", "batch_specs",
           "cache_specs", "place_cache"]


def _emb_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def text_len(cfg, seq_len: int) -> int:
    """Token-sequence length for a given total-cell seq_len (the vlm
    cell's seq_len counts the patch prefix)."""
    if cfg.family == "vlm":
        return max(2, seq_len - cfg.n_patches)
    return seq_len


def make_batch(cfg, batch: int, seq_len: int, seed: int = 0,
               device=None) -> dict:
    """Real arrays for a prefill step, on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    s = text_len(cfg, seq_len)
    dtype = _emb_dtype(cfg)
    out = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, size=(batch, s)), dtype=torch.int32,
        device=dev)}
    if cfg.family == "audio":
        out["frames"] = torch.as_tensor(
            rng.standard_normal((batch, cfg.encoder_seq, cfg.d_model)),
            device=dev).to(dtype)
    if cfg.family == "vlm":
        out["patches"] = torch.as_tensor(
            rng.standard_normal((batch, cfg.n_patches, cfg.d_model)),
            device=dev).to(dtype)
    return out


def batch_specs(cfg, shape) -> dict:
    """TensorSpecs for the train/prefill inputs of one shape cell."""
    b = shape.global_batch
    if shape.kind == "decode":
        return {"tokens": TensorSpec((b, 1), torch.int32)}
    s = text_len(cfg, shape.seq_len)
    out = {"tokens": TensorSpec((b, s), torch.int32)}
    if cfg.family == "audio":
        out["frames"] = TensorSpec((b, cfg.encoder_seq, cfg.d_model),
                                   _emb_dtype(cfg))
    if cfg.family == "vlm":
        out["patches"] = TensorSpec((b, cfg.n_patches, cfg.d_model),
                                    _emb_dtype(cfg))
    return out


def cache_specs(cfg, shape) -> dict:
    """Decode-cell cache stand-ins: a cache of seq_len positions, with
    the reference's keys (``pos`` a 0-d int32)."""
    cache = transformer.init_cache(cfg, shape.global_batch, shape.seq_len,
                                   device="meta")
    return {k: (TensorSpec((), torch.int32) if k == "pos"
                else TensorSpec(tuple(v.shape), v.dtype))
            for k, v in cache.items()}


def input_specs(cfg, shape) -> dict:
    """Everything the step consumes, minus params and optimizer."""
    specs = {"batch": batch_specs(cfg, shape)}
    if shape.kind == "decode":
        specs["cache"] = cache_specs(cfg, shape)
    return specs


def place_cache(cfg, cache: dict, mesh, device=None) -> dict:
    """``cache`` (``init_cache``'s, of any device: only its shapes are
    read) as zeros placed on ``mesh`` by the ``model`` entries of
    ``rules.cache_pspec``: the k/v caches' heads where they divide the
    axis, else their sequence where it does, else whole on every rank.
    Each tensor is a DTensor whose local block this rank allocates on
    ``device`` (default ``cuda``).  The batch rows are the caller's: the
    ranks of a model group serve the same rows, so the other axes hold
    them alike."""
    from torch.distributed.tensor import DTensor

    from ..sharding.rules import cache_pspec, placements

    dev = resolve_device(device)
    tensors = {k: v for k, v in cache.items() if isinstance(v, torch.Tensor)}
    specs = cache_pspec(cfg, None, mesh, tensors)
    out = dict(cache)
    for name, v in tensors.items():
        spec = tuple("model" if e == "model" or (
            isinstance(e, tuple) and "model" in e) else None
            for e in specs[name])
        where = placements(mesh, spec)
        shape = list(v.shape)
        for p in where:
            if p.is_shard():
                shape[p.dim] //= mesh.size(mesh.mesh_dim_names.index(
                    "model"))
        out[name] = DTensor.from_local(
            torch.zeros(shape, dtype=v.dtype, device=dev), mesh, where,
            run_check=False, shape=v.shape,
            stride=torch.empty(v.shape, device="meta").stride())
    return out
