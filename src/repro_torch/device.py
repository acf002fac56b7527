"""Where the port's tensors live.

Every entry point takes a ``device`` argument and resolves it here.  The
default is the GPU: with no argument and no CUDA the call raises instead
of quietly running on the CPU.  The CPU is used only when a caller asks
for it, as the tests do.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(
    device: Optional[Union[str, torch.device]] = None,
) -> torch.device:
    """``None`` means ``"cuda"``; ``"cpu"`` and ``"meta"`` only when asked
    for by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev
