"""What every kernel wrapper asks before it launches: where its tensors
lie, and the card and stream to launch on."""

from __future__ import annotations

import torch

__all__ = ["launch_args", "on_cpu"]


def on_cpu(*ts: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU; raises unless all lie on
    one CUDA device otherwise."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: "
                         f"{sorted(map(str, devs))}")
    dev = next(iter(devs))
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def launch_args(t: torch.Tensor) -> tuple[int, int]:
    """(card index, current stream handle) for a launch on ``t``'s card."""
    dev = t.device.index if t.device.index is not None else \
        torch.cuda.current_device()
    return dev, torch.cuda.current_stream(dev).cuda_stream
