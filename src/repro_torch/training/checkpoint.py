"""Atomic checkpoints with keep-N retention.

The port of ``src/repro/training/checkpoint.py``, with the reference's
layout (one directory per step):

  <dir>/step_000000420/
     manifest.json       # leaf names, shapes, dtypes
     arrays.npz          # one entry per leaf (copied to the host)
     _COMMITTED          # written last — torn checkpoints are never loaded

A tree is a nested dict of tensors, such as ``{"params":
model.state_dict(), "opt": opt}``; a leaf's name is its keys joined by
dots (``params.layers.0.attn.wq``, ``opt.m.embed``, ``opt.step``).  bf16
has no numpy dtype, so it is stored as its raw 16-bit words beside its
dtype tag.  Fault tolerance: ``latest_step`` only considers committed
checkpoints, so a job killed mid-save restarts from the previous one.
``restore(..., device=)`` places the arrays on one device, where the
reference's ``shardings`` re-place them on a mesh; elastic resharding
waits for the sharding slice (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np
import torch

__all__ = ["save", "restore", "latest_step", "list_steps"]

_COMMIT = "_COMMITTED"


def _flatten_with_names(tree: dict, prefix: str = "") -> tuple:
    names, leaves = [], []
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            n, l = _flatten_with_names(value, name + ".")
            names += n
            leaves += l
        else:
            names.append(name)
            leaves.append(value)
    return names, leaves


def _unflatten_like(tree: dict, leaves: list) -> dict:
    it = iter(leaves)

    def build(t):
        return {k: build(v) if isinstance(v, dict) else next(it)
                for k, v in t.items()}
    return build(tree)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def save(ckpt_dir, step: int, tree: dict, *, keep: int = 3,
         extra_meta: Optional[dict] = None) -> Path:
    """Copy every leaf to the host and write an atomic checkpoint."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:09d}"
    names, leaves = _flatten_with_names(tree)
    arrays = []
    for leaf in leaves:
        x = leaf.detach().cpu()
        # bf16 has no numpy dtype -> store raw bits + dtype tag
        arrays.append(x.view(torch.int16).numpy().view(np.uint16)
                      if x.dtype == torch.bfloat16 else x.numpy())
    manifest = {
        "step": step,
        "names": names,
        "dtypes": [_dtype_name(l) for l in leaves],
        "shapes": [list(l.shape) for l in leaves],
        "extra": extra_meta or {},
    }
    tmp = Path(tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_"))
    try:
        np.savez(tmp / "arrays.npz",
                 **{f"a{i}": a for i, a in enumerate(arrays)})
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        (tmp / _COMMIT).write_text("ok")
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)
    _retain(ckpt_dir, keep)
    return final


def _retain(ckpt_dir: Path, keep: int) -> None:
    steps = list_steps(ckpt_dir)
    for s in steps[:-keep]:
        shutil.rmtree(ckpt_dir / f"step_{s:09d}", ignore_errors=True)


def list_steps(ckpt_dir) -> list[int]:
    ckpt_dir = Path(ckpt_dir)
    out = []
    if not ckpt_dir.exists():
        return out
    for p in ckpt_dir.iterdir():
        if p.name.startswith("step_") and (p / _COMMIT).exists():
            out.append(int(p.name.split("_")[1]))
    return sorted(out)


def latest_step(ckpt_dir) -> Optional[int]:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir, step: int, like_tree: dict, *, device=None) -> dict:
    """Load a checkpoint into the structure of ``like_tree`` (its leaves
    give the names; the dtypes and shapes are the checkpoint's).  Each
    array goes to ``device``, or, where that is None, to the device of
    the leaf of ``like_tree`` it replaces."""
    path = Path(ckpt_dir) / f"step_{step:09d}"
    if not (path / _COMMIT).exists():
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    manifest = json.loads((path / "manifest.json").read_text())
    names, leaves = _flatten_with_names(like_tree)
    if names != manifest["names"]:
        raise ValueError(
            "checkpoint tree mismatch:\n"
            f"  want {names[:5]}...\n  have {manifest['names'][:5]}...")
    out = []
    with np.load(path / "arrays.npz") as data:
        for i, (leaf, dt) in enumerate(zip(leaves, manifest["dtypes"])):
            arr = data[f"a{i}"]
            x = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
                 if dt == "bfloat16" else torch.from_numpy(arr))
            out.append(x.to(leaf.device if device is None else device))
    return _unflatten_like(like_tree, out)
