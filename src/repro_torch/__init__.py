"""PALPATINE on PyTorch and CUDA.

The port of :mod:`repro` (the JAX reference package) to one NVIDIA H100.
The client's host-side simulation is copied module by module; VMSP
mining keeps its bitmaps on the device and counts support with the
hand-written Hopper kernels in :mod:`repro_torch.kernels`.

Importing this package never loads JAX or anything of :mod:`repro`.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
