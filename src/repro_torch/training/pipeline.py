"""GPipe-style pipeline parallelism over one mesh axis.

The port of ``src/repro/training/pipeline.py``, as per-rank code where
the reference's is a ``shard_map`` body: each rank of the stage axis runs
one stage, microbatches move stage s -> s+1 with ``dist.batch_isend_irecv``
once per tick, and the classic GPipe schedule (M microbatches over S
stages, M+S-1 ticks) keeps every stage busy after the fill phase.  Bubble
fraction = (S-1)/(M+S-1).  Only the last stage emits; its outputs reach
every rank by an all-reduce from zeros (the reference's masked ``psum``).
The reference's ring also sends the last stage's activation back to
stage 0, which ignores it; here the chain stops at the last stage.

The schedule is differentiable, as the reference's is under
``jax.grad``: each tick's send and receive is one autograd function whose
backward sends the received activation's gradient back to the previous
stage and receives the sent one's from the next, so the backward runs
the ticks in reverse on every rank in step; the masked all-reduce passes
its gradient through, and the input and plain (replicated) stage
parameters take their gradients summed over the stages, as a replicated
input's is.

Used by ``tests/test_torch_distributed.py`` (outputs and gradients equal
to the sequential stack's on 4 gloo ranks).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..sharding import tp
from ..sharding.place import is_dtensor, mesh_coordinate

__all__ = ["pipeline_apply", "bubble_fraction"]


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_stages - 1 + n_microbatches)


def _stage_slice(p, n_stages: int, stage: int) -> torch.Tensor:
    """This stage's slice of a stacked parameter: the local shard of a
    DTensor placed ``Shard(0)`` on the stage axis, else row ``stage``."""
    if is_dtensor(p):
        local = p.to_local()
        if local.shape[0] != 1:
            raise ValueError("stage parameters must be Shard(0) on the "
                             "stage axis")
        return local[0]
    if p.shape[0] != n_stages:
        raise ValueError(f"{p.shape[0]} stacked stages for {n_stages}")
    return p[stage]


def _exchange(h: torch.Tensor, state: torch.Tensor, stage: int,
              n_stages: int, peer, group, backward: bool = False) -> None:
    """Send ``h`` to the next stage and receive ``state`` from the previous
    one (``backward``: the reverse direction), each where that stage
    exists."""
    ahead, behind = (stage - 1, stage + 1) if backward else (stage + 1,
                                                             stage - 1)
    ops = []
    if 0 <= ahead < n_stages:
        ops.append(dist.P2POp(dist.isend, h.contiguous(), peer(ahead), group))
    if 0 <= behind < n_stages:
        ops.append(dist.P2POp(dist.irecv, state, peer(behind), group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()


class _Tick(torch.autograd.Function):
    """One tick's hand-over: ``h`` goes to the next stage, the previous
    stage's activation comes back (zeros on stage 0)."""

    @staticmethod
    def forward(ctx, h, stage, n_stages, peer, group):
        ctx.args = (stage, n_stages, peer, group)
        state = torch.zeros_like(h)
        _exchange(h, state, stage, n_stages, peer, group)
        return state

    @staticmethod
    def backward(ctx, g):
        stage, n_stages, peer, group = ctx.args
        grad = torch.zeros_like(g)
        _exchange(g, grad, stage, n_stages, peer, group, backward=True)
        return grad, None, None, None, None


def pipeline_apply(stage_fn, stage_params: dict, x: torch.Tensor, *,
                   mesh, axis: str) -> torch.Tensor:
    """Run ``x`` through ``n_stages`` sequential stages, pipelined over
    ``axis``; every rank of the axis calls this.

    Args:
      stage_fn: (params_slice, h) -> h, one pipeline stage.
      stage_params: dict of tensors with leading dim = n_stages (plain,
        the same on every rank, or DTensors ``Shard(0)`` on ``axis``).
      x: (n_microbatches, mb, ...) microbatched input, the same on every
        rank.
      mesh: the ``DeviceMesh``; ``axis`` must be one of its axes.

    Returns: (n_microbatches, mb, ...) outputs, on every rank.
    """
    n_stages, stage = mesh_coordinate(mesh, axis)
    group = mesh.get_group(axis) if n_stages > 1 else None
    axis_tp = tp.TP(n_stages, stage, group)
    if group is not None:
        # replicated inputs: their gradients are summed over the stages
        x = tp.copy_to(x, axis_tp)
        stage_params = {k: v if is_dtensor(v) else tp.copy_to(v, axis_tp)
                        for k, v in stage_params.items()}
    params = {k: _stage_slice(v, n_stages, stage)
              for k, v in stage_params.items()}
    n_micro = x.shape[0]
    n_ticks = n_micro + n_stages - 1
    last = stage == n_stages - 1
    peer = (lambda s: dist.get_global_rank(group, s)) if group else None

    state = torch.zeros_like(x[0])
    outs = []
    for t in range(n_ticks):
        # stage 0 ingests microbatch t (while t < n_micro); the terms each
        # stage adds as zeros (stage 0's received state, the others' input)
        # keep every rank's ticks and input in its backward
        inject = x[min(t, n_micro - 1)]
        if stage == 0:
            h = (inject if t < n_micro else inject * 0) + state
        else:
            h = state + inject * 0
        h = stage_fn(params, h)
        # the last stage emits microbatch t-(S-1); the others' zeros keep
        # their ticks in the graph, so every rank's backward runs them
        if t >= n_stages - 1:
            outs.append(h if last else h * 0)
        # hand activations on, stage s -> s+1
        if n_stages > 1:
            state = _Tick.apply(h, stage, n_stages, peer, group)
    outs = torch.stack(outs)
    # only the last stage holds real outputs: an all-reduce from zeros
    return outs if group is None else tp.reduce_from(outs, axis_tp)
