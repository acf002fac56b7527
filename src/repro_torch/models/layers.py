"""Shared building blocks: norms, RoPE, initializers, SwiGLU and GELU
MLPs.

The port of ``src/repro/models/layers.py``.  Weights keep the
reference's ``(in, out)`` orientation (``x @ w``), and the casts stay
where the reference has them: norms and RoPE compute in f32 and cast back
to the input's dtype.

Parameters live in :class:`Params` modules, which also answer
``p["name"]`` as the reference's dicts do, so every function here takes
either a module or a plain dict of tensors.  Initializers draw from an
explicit ``torch.Generator`` on the device the weights are made on.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..sharding import place, tp

__all__ = [
    "Params", "dense_init", "embed_init", "init_device", "norm_apply", "norm_init", "rope",
    "swiglu_mlp", "mlp_init", "gelu_mlp", "raw",
]


class Params(nn.Module):
    """A named group of weights (no ``forward``): ``p["w"]`` is ``p.w``
    (gathered to a full local tensor where it is a DTensor).
    A value that is itself a module (a norm's ``Params`` inside a block)
    is kept as a submodule.

    Weights are made with ``requires_grad=False``, so serving records no
    autograd graph; the trainer switches them on with
    ``model.requires_grad_(True)`` (:mod:`repro_torch.training`)."""

    def __init__(self, **tensors):
        super().__init__()
        for name, t in tensors.items():
            if isinstance(t, nn.Module):
                self.add_module(name, t)
            else:
                self.register_parameter(
                    name, nn.Parameter(t, requires_grad=False))

    def __getitem__(self, name: str) -> torch.Tensor:
        # a DTensor weight is gathered whole at its use (sharding.place);
        # the tensor-parallel path reads its model block (sharding.tp)
        return place.local(getattr(self, name))


def raw(p, name: str):
    """A weight as stored (a DTensor stays one), from a module or a
    dict."""
    return getattr(p, name) if isinstance(p, nn.Module) else p[name]


def init_device(generator: torch.Generator) -> torch.device:
    """Where an initializer makes its tensor: the generator's device, or
    the ``meta`` device inside ``with torch.device("meta")``, where a
    model is built for its shapes alone (a CPU generator, no storage)."""
    if torch.get_default_device().type == "meta":
        return torch.device("meta")
    return generator.device


def dense_init(generator: torch.Generator, shape,
               dtype=torch.float32, scale: Optional[float] = None
               ) -> torch.Tensor:
    """Truncated-normal fan-in init (LeCun), truncated at ±2 as
    ``jax.random.truncated_normal(-2, 2)``, times ``scale`` (default
    ``fan_in ** -0.5``); drawn in f32 on the generator's device, then
    cast."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    w = torch.empty(shape, dtype=torch.float32,
                    device=init_device(generator))
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.mul_(fan_in ** -0.5 if scale is None else scale).to(dtype)


def embed_init(generator: torch.Generator, shape,
               dtype=torch.float32) -> torch.Tensor:
    w = torch.empty(shape, dtype=torch.float32,
                    device=init_device(generator))
    nn.init.normal_(w, 0.0, 1.0, generator=generator)
    return w.mul_(0.02).to(dtype)


def norm_init(d: int, kind: str, dtype=torch.float32,
              device=None) -> Params:
    if kind == "rmsnorm":
        return Params(scale=torch.ones(d, dtype=dtype, device=device))
    return Params(scale=torch.ones(d, dtype=dtype, device=device),
                  bias=torch.zeros(d, dtype=dtype, device=device))


def norm_apply(p, x: torch.Tensor, kind: str, eps: float = 1e-6
               ) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        var = (xf * xf).mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * p["scale"].float()
    else:
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + eps)
        out = out * p["scale"].float() + p["bias"].float()
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Half-rotation RoPE.  x: (..., S, H, D); positions: (..., S)."""
    half = x.shape[-1] // 2
    exponent = torch.arange(0, half, dtype=torch.float32,
                            device=x.device) / half
    freqs = 1.0 / (theta ** exponent)
    # (..., S, 1, 1) * (half,) -> (..., S, 1, half)
    angles = positions[..., :, None, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp_init(generator: torch.Generator, d: int, f: int, dtype,
             kind: str = "swiglu") -> Params:
    if kind == "swiglu":
        return Params(w1=dense_init(generator, (d, f), dtype=dtype),
                      w3=dense_init(generator, (d, f), dtype=dtype),
                      w2=dense_init(generator, (f, d), dtype=dtype))
    return Params(w1=dense_init(generator, (d, f), dtype=dtype),
                  w2=dense_init(generator, (f, d), dtype=dtype))


def _mlp(p, x: torch.Tensor, hidden, columns: tuple, t: Optional[tp.TP],
         seq: bool) -> torch.Tensor:
    """``hidden(w, x) @ w2``.  With ``t`` (the ``model`` axis) and the
    ``columns`` weights column-, w2 row-sharded there, each rank computes
    its block of d_ff: ``x`` enters by ``copy_to`` (a sequence shard under
    ``seq``, by ``gather_sum``) and the partial product leaves by
    ``reduce_from`` (``reduce_scatter``).  Otherwise the weights are whole
    on every rank (``tp.whole``)."""
    if all(tp.sharded(t, raw(p, n), 1) for n in columns) and tp.sharded(
            t, raw(p, "w2"), 0):
        w = {n: place.local(raw(p, n), keep_model=True)
             for n in (*columns, "w2")}
        x = tp.gather_sum(x, 1, t) if seq else tp.copy_to(x, t)
        y = hidden(w, x) @ w["w2"]
        return tp.reduce_scatter(y, 1, t) if seq else tp.reduce_from(y, t)
    return tp.whole(lambda x: hidden(p, x) @ p["w2"], x, t, seq)


def swiglu_mlp(p, x: torch.Tensor, t: Optional[tp.TP] = None,
               seq: bool = False) -> torch.Tensor:
    return _mlp(p, x, lambda w, x: F.silu(x @ w["w1"]) * (x @ w["w3"]),
                ("w1", "w3"), t, seq)


def gelu_mlp(p, x: torch.Tensor, t: Optional[tp.TP] = None,
             seq: bool = False) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation; whisper's, whose d_ff
    # splits over the model axis as swiglu_mlp's does
    return _mlp(p, x, lambda w, x: F.gelu(x @ w["w1"], approximate="tanh"),
                ("w1",), t, seq)
