"""Parameters placed as DTensors on a ``DeviceMesh``, and the sharded
step's gather of each weight at its use.

The counterpart of the reference's ``jax.device_put(params,
named(mesh, specs))`` and of the per-layer all-gathers XLA inserts for
FSDP-sharded weights.  :func:`distribute_model` turns every parameter of
a model into a DTensor placed by its spec (``rules.param_specs``), so a
rank holds only its shard.  The model's functions read a weight through
``Params.__getitem__`` (or :func:`local`), which all-gathers a DTensor to
a full local tensor just before its use; inside a remat block that
happens again in the backward's recompute, so at most a block's weights
are whole at once.  The gradient of the gathered tensor flows back as a
partial sum over the mesh axes the batch rows are split over
(:func:`batch_axes`), which DTensor reduce-scatters onto the
parameter's placement.  Activations stay plain local tensors: each rank
holds its rows of the batch.  A weight the tensor-parallel path computes
with (``sharding.tp``) is gathered over its other axes only and keeps
its ``model`` shard (``local(..., keep_model=True)``); the rest are
gathered whole.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

__all__ = ["batch_axes", "distribute_model", "is_dtensor", "local",
           "local_bytes", "local_rows", "mesh_coordinate"]

#: the mesh axes the running step's batch rows are split over
_BATCH_AXES: tuple = ()


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


@contextlib.contextmanager
def batch_axes(axes: tuple):
    """The batch rows of the step run inside are split over ``axes``: a
    gathered weight's gradient is a partial sum over them."""
    global _BATCH_AXES
    prev, _BATCH_AXES = _BATCH_AXES, tuple(axes)
    try:
        yield
    finally:
        _BATCH_AXES = prev


def current_batch_axes() -> tuple:
    return _BATCH_AXES


def local(t, partial_axes: tuple | None = None, *, keep_model: bool = False):
    """``t`` as a plain tensor: a DTensor is all-gathered to a full
    replica on this rank, its gradient a partial sum over
    ``partial_axes`` (the axes whose ranks use it on other tokens; by
    default the batch axes); any other tensor is returned as it is.
    With ``keep_model`` a DTensor sharded on the ``model`` axis is
    gathered over its other axes only: the result is this rank's
    ``model`` block, and so is its gradient."""
    if type(t) in (torch.Tensor, nn.Parameter) or not is_dtensor(t):
        return t
    from torch.distributed.tensor import Partial, Replicate

    partial = _BATCH_AXES if partial_axes is None else partial_axes
    mesh = t.device_mesh
    kept = [p if keep_model and n == "model" and p.is_shard() else None
            for n, p in zip(mesh.mesh_dim_names, t.placements)]
    target = [k or Replicate() for k in kept]
    # a weight already placed so (the inference specs' blocks) moves not;
    # under autograd the redistribution stays, as its backward reduces the
    # partial gradient onto the weight's placement
    moves = list(t.placements) != target or (
        torch.is_grad_enabled() and t.requires_grad)
    full = t.redistribute(mesh, target) if moves else t
    grad = [k or (Partial() if n in partial else Replicate())
            for n, k in zip(mesh.mesh_dim_names, kept)]
    return full.to_local(grad_placements=grad)


def distribute_model(model: nn.Module, specs: dict, mesh) -> nn.Module:
    """Place every parameter of ``model`` as a DTensor by its spec
    (``{name: spec}``, as ``rules.param_specs`` gives); in place.  Each
    rank must hold the same full weights (the same seed) before."""
    from torch.distributed.tensor import distribute_tensor

    from .rules import placements

    # by name, so each replaced weight is freed before the next is placed
    for name in [n for n, _ in model.named_parameters()]:
        owner = model.get_submodule(name.rpartition(".")[0])
        leaf = name.rpartition(".")[2]
        p = owner._parameters[leaf]
        owner._parameters[leaf] = nn.Parameter(
            distribute_tensor(p.detach(), mesh,
                              list(placements(mesh, specs[name]))),
            requires_grad=p.requires_grad)
        del p
    return model


def mesh_coordinate(mesh, axis: str) -> tuple:
    """(size, this rank's index) on ``axis`` of a ``DeviceMesh``; (1, 0)
    where the mesh lacks the axis, and on an abstract mesh of one rank
    per axis."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if axis not in names:
        return 1, 0
    if isinstance(mesh.shape, dict):
        if mesh.shape[axis] != 1:
            raise ValueError("an abstract mesh runs nothing past one rank "
                             "an axis")
        return 1, 0
    return mesh.size(names.index(axis)), mesh.get_local_rank(axis)


def local_rows(x: torch.Tensor, mesh, spec: tuple) -> torch.Tensor:
    """This rank's block of ``x`` by a batch spec (dim 0 over the named
    axes, the first the outermost), as ``distribute_tensor`` places it;
    ``x`` itself where the spec replicates it."""
    entry = spec[0] if spec else None
    for axis in (entry if isinstance(entry, tuple) else (entry,)):
        if axis is not None:
            n, i = mesh_coordinate(mesh, axis)
            x = x.chunk(n, dim=0)[i]
    return x


def local_bytes(tensors) -> int:
    """Bytes this rank holds of ``tensors`` (DTensors count their local
    shard)."""
    total = 0
    for t in tensors:
        t = t.to_local() if is_dtensor(t) else t
        total += t.numel() * t.element_size()
    return total
