"""Batch construction for the examples and tests.

The port of ``make_batch`` and ``text_len`` of ``src/repro/models/io.py``:
the same numpy draws from ``default_rng(seed)``, so one seed gives the
same tokens in both packages.  The reference's ShapeDtypeStruct specs
serve its dry-run only and are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["make_batch", "text_len"]


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
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
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
