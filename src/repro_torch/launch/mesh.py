"""Mesh construction on ``torch.distributed``.

The port of ``src/repro/launch/mesh.py``.  The process group is the
caller's: start it (``torch.distributed.init_process_group``, or
:func:`init_from_store` from a ``FileStore`` or ``TCPStore``) before
building a ``DeviceMesh``; the mesh's device type, and with it the
backend, follows the device: NCCL for ``cuda``, gloo for ``cpu``.  A
``cuda`` mesh needs an NCCL group and never runs on gloo.
``make_abstract_mesh`` needs no group: the spec functions of
:mod:`repro_torch.sharding.rules` read only its axis sizes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["make_production_mesh", "make_local_mesh", "make_abstract_mesh",
           "init_from_store"]


def init_from_store(store, rank: int, world_size: int, device=None) -> str:
    """Start the default process group on ``store`` with the device's
    backend (NCCL for ``cuda``, gloo for ``cpu``); returns the backend.
    A failure raises: there is no fallback to another backend or to one
    rank."""
    dev = resolve_device(device)
    backend = {"cuda": "nccl", "cpu": "gloo"}[dev.type]
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size)
    return backend


def _check_group(device_type: str, n: int) -> None:
    if not dist.is_initialized():
        raise RuntimeError("no process group: start one before a mesh")
    if dist.get_world_size() < n:
        raise ValueError(f"a mesh of {n} ranks needs as many; the group "
                         f"has {dist.get_world_size()}")
    backend = dist.get_backend()
    if device_type == "cuda" and "nccl" not in backend:
        raise RuntimeError(f"a cuda mesh needs an NCCL group, not {backend}")


def _mesh(device_type: str, shape: tuple, axes: tuple):
    from torch.distributed.device_mesh import init_device_mesh

    n = 1
    for s in shape:
        n *= s
    _check_group(device_type, n)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """Single pod: 16x16 = 256 ranks (data, model).  Multi-pod: 2 pods x
    256 ranks (pod, data, model) — 'pod' is the outer data-parallel axis
    (and can be re-bound to pipeline stages, see training/pipeline.py).
    On ``device``'s type (default ``cuda``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(resolve_device(device).type, shape, axes)


def make_local_mesh(data: int = 1, model: int = 1, device=None):
    """A (data, model) mesh over the ranks of the running group, on
    ``device``'s type (default ``cuda``)."""
    return _mesh(resolve_device(device).type, (data, model),
                 ("data", "model"))


class AbstractMesh(NamedTuple):
    """A device-free mesh: ``shape`` is ``{axis: size}``."""

    shape: dict
    axis_names: tuple

    @property
    def mesh_dim_names(self) -> tuple:
        return self.axis_names


def make_abstract_mesh(shape: tuple, axes: tuple) -> AbstractMesh:
    """Device-free mesh for spec construction on hosts without the
    ranks."""
    return AbstractMesh(dict(zip(axes, shape)), tuple(axes))
