"""GPipe-style pipeline parallelism over one mesh axis.

The port of ``src/repro/training/pipeline.py``, as per-rank code where
the reference's is a ``shard_map`` body: each rank of the stage axis runs
one stage, microbatches move stage s -> s+1 with ``dist.batch_isend_irecv``
once per tick, and the classic GPipe schedule (M microbatches over S
stages, M+S-1 ticks) keeps every stage busy after the fill phase.  Bubble
fraction = (S-1)/(M+S-1).  Only the last stage emits; its outputs reach
every rank by an all-reduce from zeros (the reference's masked ``psum``).
The reference's ring also sends the last stage's activation back to
stage 0, which ignores it; here the chain stops at the last stage.  The
schedule is a forward pass: sends and receives record no autograd graph.

Used by ``tests/test_torch_distributed.py`` (numerical equality with the
sequential stack on 4 gloo ranks).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

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


@torch.no_grad()
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
    params = {k: _stage_slice(v, n_stages, stage)
              for k, v in stage_params.items()}
    n_micro = x.shape[0]
    n_ticks = n_micro + n_stages - 1
    last = stage == n_stages - 1
    peer = (lambda s: dist.get_global_rank(group, s)) if group else None

    state = torch.zeros_like(x[0])
    outs = torch.zeros_like(x)
    for t in range(n_ticks):
        # stage 0 ingests microbatch t (while t < n_micro)
        if stage == 0:
            h = x[t] if t < n_micro else torch.zeros_like(x[0])
        else:
            h = state
        h = stage_fn(params, h)
        # the last stage emits microbatch t-(S-1)
        if last and t >= n_stages - 1:
            outs[t - (n_stages - 1)] = h
        # hand activations on, stage s -> s+1
        if n_stages > 1:
            ops = []
            if not last:
                ops.append(dist.P2POp(dist.isend, h.contiguous(),
                                      peer(stage + 1), group))
            if stage > 0:
                state = torch.empty_like(h)
                ops.append(dist.P2POp(dist.irecv, state, peer(stage - 1),
                                      group))
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    # only the last stage holds real outputs: mask + all-reduce
    if not last:
        outs.zero_()
    if group is not None:
        dist.all_reduce(outs, group=group)
    return outs
