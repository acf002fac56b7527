"""PALPATINE on PyTorch and CUDA.

The port of :mod:`repro` (the JAX reference package) to one NVIDIA H100.
The client's host-side simulation is copied module by module; VMSP
mining keeps its bitmaps on the device and counts support with the
hand-written Hopper kernels in :mod:`repro_torch.kernels`.  The LM
serving stack (:mod:`repro_torch.models`, :mod:`repro_torch.serving`,
``python -m repro_torch.launch.serve``) runs every family, with prefill
attention on the hand-written Hopper flash-attention kernels; the
trainer (:mod:`repro_torch.training`, :mod:`repro_torch.data`,
``python -m repro_torch.launch.train``) trains them with the plain or
the blocked attention (the kernels have no backward).

Importing this package never loads JAX or anything of :mod:`repro`.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
