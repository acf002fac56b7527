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

Sharded trees: ``save`` gathers a DTensor leaf whole on every rank (a
collective: every rank of the mesh calls it) and only rank 0 of the
process group writes; the others wait for the commit.  ``restore(...,
mesh=, placements=)`` places each loaded array as a DTensor by its entry
of ``placements`` (a tree matching ``like_tree``; ``None`` keeps a leaf
plain), which may be another layout, on another mesh, than the one that
saved it: the elastic restart of the reference's ``shardings=``.
``restore(..., device=)`` places the arrays on one device.
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
import torch.distributed as dist

from ..sharding.place import is_dtensor

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
        if is_dtensor(leaf):
            leaf = leaf.full_tensor()
        x = leaf.detach().cpu()
        # bf16 has no numpy dtype -> store raw bits + dtype tag
        arrays.append(x.view(torch.int16).numpy().view(np.uint16)
                      if x.dtype == torch.bfloat16 else x.numpy())
    if dist.is_initialized() and dist.get_rank() != 0:
        dist.barrier()                       # rank 0 commits
        return final
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
    if dist.is_initialized():
        dist.barrier()
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


def restore(ckpt_dir, step: int, like_tree: dict, *, device=None,
            mesh=None, placements: Optional[dict] = None) -> dict:
    """Load a checkpoint into the structure of ``like_tree`` (its leaves
    give the names; the dtypes and shapes are the checkpoint's).  Each
    array goes to ``device``, or, where that is None, to the device of
    the leaf of ``like_tree`` it replaces; with ``mesh`` and
    ``placements`` (a tree matching ``like_tree`` of DTensor placement
    tuples, or None for a leaf that stays plain) it is placed as a
    DTensor on ``mesh`` (every rank of the mesh calls this)."""
    path = Path(ckpt_dir) / f"step_{step:09d}"
    if not (path / _COMMIT).exists():
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    manifest = json.loads((path / "manifest.json").read_text())
    names, leaves = _flatten_with_names(like_tree)
    if names != manifest["names"]:
        raise ValueError(
            "checkpoint tree mismatch:\n"
            f"  want {names[:5]}...\n  have {manifest['names'][:5]}...")
    if (mesh is None) != (placements is None):
        raise ValueError("mesh and placements go together")
    where = (_flatten_with_names(placements)[1] if placements is not None
             else [None] * len(leaves))
    if len(where) != len(leaves):
        raise ValueError("placements do not match the tree")
    out = []
    with np.load(path / "arrays.npz") as data:
        for i, (leaf, dt, pl) in enumerate(
                zip(leaves, manifest["dtypes"], where)):
            arr = data[f"a{i}"]
            x = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
                 if dt == "bfloat16" else torch.from_numpy(arr))
            if pl is not None:
                from torch.distributed.tensor import distribute_tensor

                x = distribute_tensor(x.to(_mesh_device(mesh)), mesh,
                                      list(pl))
            else:
                x = x.to(device if device is not None else
                         leaf.to_local().device if is_dtensor(leaf)
                         else leaf.device)
            out.append(x)
    return _unflatten_like(like_tree, out)


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
