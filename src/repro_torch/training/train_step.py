"""Train / prefill / decode step functions.

The port of ``src/repro/training/train_step.py``.  ``make_steps(cfg,
opt_cfg)`` returns closures over a model (an ``nn.Module`` of weights,
updated in place) in place of the reference's functions of a params
pytree: ``jax.value_and_grad`` becomes ``torch.autograd.grad`` of
``loss_fn``, the microbatch ``lax.scan`` a Python loop over slices along
axis 0 whose gradients are accumulated in f32 and averaged, as the
reference's.  Optional int8 gradient compression quantizes the
gradients in blocks before the update (see ``training/compression.py``),
over the reference's layer-stacked leaves (:func:`_compress_round_trip`).

With ``mesh=`` the step is the reference's sharded ``jax.jit``: the
model's parameters are DTensors (``sharding.place.distribute_model``),
each rank takes its rows of the batch by ``rules.batch_specs_pspec``'s
rule (dim 0 over the data axes where it divides them), each weight is
gathered at its use (over every axis, or, where the model computes
tensor-parallel on the ``model`` axis, over the others: see
``sharding.tp``) and its gradient, a partial sum over the batch axes,
reduce-scattered onto its placement, and the loss is the mean over the
global batch.  Compression under a mesh blocks each global gradient as
the reference's does: a placed gradient is gathered whole, compressed
with its layer's stack, and each rank keeps its block of the result.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.obs import SPAN_OPTIMIZER, program_span
from ..models import decode_step as model_decode
from ..models import forward, loss_fn
from ..sharding import place
from ..sharding.rules import axis_sizes
from .compression import compress_tree, decompress_tree
from .optimizer import OptConfig, adamw_init, adamw_update

__all__ = ["batch_rows", "make_steps", "mesh_loss", "TrainStepConfig"]


def _compress_round_trip(grads: dict) -> dict:
    """``grads`` through int8 compression and back, blocked as the
    reference blocks them: its leaves stack a parameter of every layer
    (the port's names that differ only in their integer parts, stacked in
    index order), and a block of 256 elements may straddle two layers
    where a layer's tensor is not a whole number of blocks.  A DTensor
    gradient is compressed whole (the global tensor) and comes back
    with its placement."""
    placed = {n: g for n, g in grads.items() if place.is_dtensor(g)}
    if placed:
        from torch.distributed.tensor import DTensor, Replicate

        back = _compress_round_trip(
            {n: g.full_tensor() if n in placed else g
             for n, g in grads.items()})
        for n, g in placed.items():
            mesh = g.device_mesh
            back[n] = DTensor.from_local(
                back[n], mesh, [Replicate()] * mesh.ndim,
                run_check=False).redistribute(mesh, [
                    Replicate() if p.is_partial() else p
                    for p in g.placements])
        return back
    stacks: dict = {}
    for name in grads:
        parts = name.split(".")
        key = ".".join(p for p in parts if not p.isdigit())
        index = tuple(int(p) for p in parts if p.isdigit())
        stacks.setdefault(key, []).append((index, name))
    for members in stacks.values():
        members.sort()
    back = decompress_tree(compress_tree(
        {key: torch.stack([grads[n] for _, n in members])
         for key, members in stacks.items()}))
    out = {}
    for key, members in stacks.items():
        out.update(zip((n for _, n in members), back[key].unbind()))
    return {n: out[n] for n in grads}


def batch_rows(mesh, batch: dict, axes: tuple | None = None):
    """(the mesh axes the batch rows are split over, each tensor's rows
    on this rank): dim 0 over ``axes`` (default ('pod', 'data'), those
    the mesh has) where every tensor's divides them, as
    ``rules.batch_specs_pspec`` places the batch (``all_axes``: every
    axis)."""
    sizes = axis_sizes(mesh)
    if axes is None:
        axes = tuple(a for a in ("pod", "data") if a in sizes)
    n = 1
    for a in axes:
        n *= sizes[a]
    if any(v.shape[0] % n for v in batch.values()):
        return (), batch
    return axes, {k: place.local_rows(v, mesh, (axes,))
                  for k, v in batch.items()}


def mesh_loss(cfg, model, batch: dict, mesh=None, *,
              with_local: bool = False, axes: tuple | None = None):
    """The mean loss over the global ``batch`` (the same on every rank)
    of a model placed on ``mesh`` (plain ``loss_fn`` where it is None),
    its rows split over ``axes`` as :func:`batch_rows` splits them.
    Each rank runs its rows; with ``with_local`` also returns this
    rank's share (its rows' mean over the number of row blocks), whose
    gradients, summed over the ranks by the placed weights' backward,
    are the global loss's."""
    axes, rows = (((), batch) if mesh is None
                  else batch_rows(mesh, batch, axes))
    with place.batch_axes(axes):
        loss, _ = loss_fn(cfg, model, rows)
    n_shards = 1
    for a in axes:
        n_shards *= axis_sizes(mesh)[a]
    share = loss / n_shards
    if mesh is not None and axes:
        from torch.distributed.tensor import DTensor, Partial, Replicate

        total = DTensor.from_local(
            share.detach(), mesh,
            [Partial() if name in axes else Replicate()
             for name in mesh.mesh_dim_names]).full_tensor()
    else:
        total = loss
    return (total, share) if with_local else total


def make_steps(cfg, opt_cfg: Optional[OptConfig] = None, *,
               microbatches: int = 1, compress_grads: bool = False,
               mesh=None) -> dict:
    """Returns a dict of ``train_step(model, opt, batch) -> (model, opt,
    metrics)`` (the weights switched to ``requires_grad`` and updated in
    place), ``prefill_step(model, batch)``, ``decode_step(model, cache,
    tokens)`` and ``init_opt(model)``.  With ``mesh``, ``train_step``
    takes a model placed on it and the global batch (every rank the
    same), and runs sharded."""
    opt_cfg = opt_cfg or OptConfig()

    def grads_of(params: dict, model, batch: dict):
        """(the global batch's mean loss, metrics, gradients)."""
        axes = () if mesh is None else batch_rows(mesh, batch)[0]
        # the backward recomputes remat blocks: it gathers in this context
        with place.batch_axes(axes):
            loss, share = mesh_loss(cfg, model, batch, mesh,
                                    with_local=True)
            grads = torch.autograd.grad(share, list(params.values()),
                                        allow_unused=True)
        # a weight the loss does not reach gets zeros, as jax.grad gives
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(params.items(), grads)}
        loss = loss.detach()
        return loss, {"loss": loss, "perplexity": torch.exp(loss)}, grads

    def train_step(model, opt: dict, batch: dict):
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        if microbatches > 1:
            mb = next(iter(batch.values())).shape[0] // microbatches
            acc = {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            for i in range(microbatches):
                mb_batch = {k: v[i * mb:(i + 1) * mb]
                            for k, v in batch.items()}
                mb_loss, _, grads = grads_of(params, model, mb_batch)
                for n, g in grads.items():
                    acc[n] += g
                loss = loss + mb_loss
                del grads
            grads = {n: g / microbatches for n, g in acc.items()}
            loss = loss / microbatches
            metrics = {"loss": loss, "perplexity": torch.exp(loss)}
        else:
            _, metrics, grads = grads_of(params, model, batch)
        if compress_grads:
            grads = _compress_round_trip(grads)
        with program_span(SPAN_OPTIMIZER):
            _, opt, opt_metrics = adamw_update(opt_cfg, params, grads, opt)
        if mesh is not None:
            opt_metrics = {k: v.full_tensor() if place.is_dtensor(v) else v
                           for k, v in opt_metrics.items()}
        return model, opt, {**metrics, **opt_metrics}

    @torch.no_grad()
    def prefill_step(model, batch: dict) -> torch.Tensor:
        # serving prefill: only the next-token distribution is needed —
        # unembed just the last position (a large-vocab win)
        return forward(cfg, model, batch, last_only=True)

    def decode(model, cache: dict, tokens: torch.Tensor):
        return model_decode(cfg, model, cache, tokens)

    return {
        "train_step": train_step,
        "prefill_step": prefill_step,
        "decode_step": decode,
        "init_opt": lambda model: adamw_init(dict(model.named_parameters())),
    }


TrainStepConfig = OptConfig  # re-export alias used by launch configs
