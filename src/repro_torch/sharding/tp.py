"""Tensor and sequence parallelism on the mesh's ``model`` axis, as
per-rank code.

The port's counterpart of what XLA's partitioner makes of the
reference's ``model`` specs (``rules.py``): a weight with ``model`` on
its output dim is column-parallel (``wq``/``wk``/``wv``/``w1``/``w3``,
the ``lm_head``), one with ``model`` on its input dim row-parallel
(``wo``/``w2``), the (V, D) embedding holds a block of the vocabulary,
and under ``act_shard="seq_model"`` the residual stream between blocks
is each rank's 1/|model| of the sequence.  Activations stay plain local
tensors; what a tensor is across the ranks of the axis is named by the
operation that moves it:

* replicated: the same on every rank;
* partial: its sum over the ranks is the value (a row-parallel product);
* a shard along a dim: rank i holds block i.

Every movement is an autograd function whose backward is its conjugate,
so a gradient crosses the axis as the forward's data did:

=====================  ====================  =========================
op                     forward               backward
=====================  ====================  =========================
:func:`copy_to`        identity              all-reduce
:func:`reduce_from`    all-reduce            identity
:func:`gather_sum`     all-gather            reduce-scatter
:func:`reduce_scatter` reduce-scatter        all-gather
:func:`split`          this rank's block     all-gather
:func:`gather`         all-gather            this rank's block
=====================  ====================  =========================

``copy_to`` marks a replicated tensor that enters rank-distinct work (a
column-parallel product), ``gather_sum`` the same for a sequence shard;
``gather`` and ``split`` move a tensor that every rank then uses alike.
Two more serve the recurrent mixers: :func:`part_blocks` moves a
column-parallel product whose output is several tensors side by side
(Mamba2's ``w_in``, [u | z]) to this rank's block of each, and
:func:`mean_squares` all-reduces a norm's mean square over a feature
dim the axis splits (Mamba2's gated RMSNorm), both ways.
:func:`vocab_parallel_nll` is the cross entropy over a vocabulary split
on the axis, without whole logits.

Which weights compute tensor-parallel is decided by their placement
alone (:func:`model_dim`), for every family: a block whose weights the
``model`` axis shards computes on its blocks, and weights whose
``model`` proposal fell back are gathered whole at their use
(``place.local``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from . import place

__all__ = [
    "TP", "axis_of", "copy_to", "gather", "gather_sum", "head_plan",
    "mean_squares", "model_dim", "part_blocks", "reduce_from",
    "reduce_scatter", "sharded", "split", "vocab_parallel_nll", "whole",
]


class TP(NamedTuple):
    """This rank on the ``model`` axis: its size, this rank's index and
    the axis's process group."""

    n: int
    i: int
    group: object


def _group(mesh, axis: str = "model"):
    """(size, this rank's index, process group) of ``axis``; the group is
    None where the axis has one rank."""
    n, i = place.mesh_coordinate(mesh, axis)
    return n, i, (mesh.get_group(axis) if n > 1 else None)


def model_dim(w) -> Optional[int]:
    """The dim of ``w`` that the ``model`` axis shards (a DTensor placed
    ``Shard(d)`` there), or None."""
    if not place.is_dtensor(w):
        return None
    names = w.device_mesh.mesh_dim_names or ()
    if "model" not in names:
        return None
    placement = w.placements[names.index("model")]
    return placement.dim if placement.is_shard() else None


def axis_of(cfg, weights) -> Optional[TP]:
    """The ``model`` axis a model of ``cfg`` computes tensor-parallel
    over: some weight of ``weights`` is sharded on it; None otherwise
    (the whole-weight path)."""
    for w in weights:
        if model_dim(w) is not None:
            mesh = w.device_mesh
            return TP(*place.mesh_coordinate(mesh, "model"),
                      mesh.get_group("model"))
    return None


def sharded(t: Optional[TP], w, dim: int) -> bool:
    """``w`` computes tensor-parallel on ``dim`` (a negative dim counts
    from the end)."""
    if t is None:
        return False
    d = model_dim(w)
    return d is not None and d % w.ndim == dim % w.ndim


# -- the collectives --------------------------------------------------------


def _all_gather(x: torch.Tensor, dim: int, n: int, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


def _reduce_scatter(x: torch.Tensor, dim: int, n: int, group
                    ) -> torch.Tensor:
    x0 = x.movedim(dim, 0).contiguous()
    out = x0.new_empty((x0.shape[0] // n, *x0.shape[1:]))
    dist.reduce_scatter_tensor(out, x0, group=group)
    return out.movedim(0, dim)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, n, group):
        ctx.dim, ctx.n, ctx.group = dim, n, group
        return _all_gather(x, dim, n, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.n, ctx.group), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, n, group):
        ctx.dim, ctx.n, ctx.group = dim, n, group
        return _reduce_scatter(x, dim, n, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.n, ctx.group), None, None, None


class _Split(torch.autograd.Function):
    """This rank's block along ``dim`` of a tensor the whole axis holds
    alike; the gradient's blocks are gathered back, so every rank sees
    the whole gradient."""

    @staticmethod
    def forward(ctx, x, dim, n, i, group):
        ctx.dim, ctx.n, ctx.group = dim, n, group
        return x.chunk(n, dim=dim)[i].contiguous()

    @staticmethod
    def backward(ctx, g):
        return (_all_gather(g, ctx.dim, ctx.n, ctx.group), None, None, None,
                None)


class _Gather(torch.autograd.Function):
    """The axis's blocks along ``dim`` gathered on every rank, which then
    use the whole alike: the gradient is this rank's block."""

    @staticmethod
    def forward(ctx, x, dim, n, i, group):
        ctx.dim, ctx.n, ctx.i = dim, n, i
        return _all_gather(x, dim, n, group)

    @staticmethod
    def backward(ctx, g):
        return (g.chunk(ctx.n, dim=ctx.dim)[ctx.i].contiguous(), None, None,
                None, None)


class _PartBlocks(torch.autograd.Function):
    """This rank's block of each of ``parts`` equal tensors laid side by
    side along ``dim``, from this rank's block of the whole: all-gathered,
    then sliced.  The gradient, nonzero only at this rank's slices, is
    reduce-scattered back onto the blocks."""

    @staticmethod
    def forward(ctx, x, parts, dim, n, i, group):
        ctx.parts, ctx.dim, ctx.n, ctx.i, ctx.group = parts, dim, n, i, group
        whole = _all_gather(x, dim, n, group)
        return torch.cat([p.chunk(n, dim=dim)[i]
                          for p in whole.chunk(parts, dim=dim)], dim=dim)

    @staticmethod
    def backward(ctx, g):
        blocks = []
        for gp in g.chunk(ctx.parts, dim=ctx.dim):
            zero = torch.zeros_like(gp)
            blocks += [gp if r == ctx.i else zero for r in range(ctx.n)]
        return (_reduce_scatter(torch.cat(blocks, dim=ctx.dim), ctx.dim,
                                ctx.n, ctx.group),
                None, None, None, None, None)


class _SumAll(torch.autograd.Function):
    """A partial sum all-reduced, whose value every rank then uses on its
    own block: the gradient is all-reduced too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def copy_to(x: torch.Tensor, t: TP) -> torch.Tensor:
    """A replicated ``x`` entering rank-distinct work."""
    return _CopyTo.apply(x, t.group)


def reduce_from(x: torch.Tensor, t: TP) -> torch.Tensor:
    """A partial ``x`` summed to its value on every rank."""
    return _ReduceFrom.apply(x, t.group)


def gather_sum(x: torch.Tensor, dim: int, t: TP) -> torch.Tensor:
    """The blocks of ``x`` along ``dim`` gathered for rank-distinct work:
    the gradient is summed over the ranks and scattered back."""
    return _GatherSum.apply(x, dim, t.n, t.group)


def reduce_scatter(x: torch.Tensor, dim: int, t: TP) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of a partial ``x``."""
    return _ReduceScatter.apply(x, dim, t.n, t.group)


def split(x: torch.Tensor, dim: int, t: TP) -> torch.Tensor:
    return _Split.apply(x, dim, t.n, t.i, t.group)


def gather(x: torch.Tensor, dim: int, t: TP) -> torch.Tensor:
    return _Gather.apply(x, dim, t.n, t.i, t.group)


def part_blocks(x: torch.Tensor, parts: int, dim: int, t: TP
                ) -> torch.Tensor:
    """Helper (a) of the recurrent mixers: ``x`` is this rank's block
    along ``dim`` of a column-parallel product whose whole output is
    ``parts`` tensors of equal width side by side ([u | z]); returns this
    rank's block of each, side by side.  The reference places such a
    weight by contiguous blocks (at |model| 4, ranks 0-1 hold u and 2-3
    z), which match neither the rank's heads nor its other blocks."""
    return _PartBlocks.apply(x, parts, dim, t.n, t.i, t.group)


def mean_squares(x: torch.Tensor, t: TP) -> torch.Tensor:
    """Helper (b): the f32 mean square over a feature dim the axis splits
    in equal blocks, ``x`` this rank's block of it (the last dim; keepdim):
    each rank's squares summed locally (as its mean over 1/n of the dim)
    and all-reduced, a norm over the whole dim without gathering ``x``.
    On one rank it is ``norm_apply``'s mean to the bit."""
    xf = x.float()
    part = (xf * xf).mean(dim=-1, keepdim=True)
    return _SumAll.apply(part if t.n == 1 else part / t.n, t.group)


def whole(fn, x: torch.Tensor, t: Optional[TP], seq: bool):
    """``fn(x)`` computed alike on every rank of the axis (its weights
    gathered whole): under ``seq`` the sequence shard ``x`` is gathered
    first and the result split back to this rank's block."""
    if t is None or not seq:
        return fn(x)
    return split(fn(gather(x, 1, t)), 1, t)


# -- attention heads ----------------------------------------------------------


class HeadPlan(NamedTuple):
    """What rank i of n computes of a GQA attention whose ``wo`` rows are
    split n ways: query heads ``[q0, q1)`` (those its rows of the output
    need), the key/value heads ``kv`` they read (``kv_index`` picks them
    from heads ``[kv0, kv1)``, or None where that range is already the
    grouping), and the output columns ``[c0, c1)``, relative to the first
    column of head ``q0``."""

    q0: int
    q1: int
    kv0: int
    kv1: int
    kv_index: Optional[tuple]
    c0: int
    c1: int


def head_plan(hq: int, hkv: int, hd: int, n: int, i: int) -> HeadPlan:
    """The heads rank ``i`` of ``n`` computes (see :class:`HeadPlan`).

    Query head h reads key/value head h // (hq / hkv).  Where the rank's
    query heads are whole groups, they keep the grouping; where they lie
    inside one group, one key/value head serves them all; otherwise each
    query head gets its key/value head (``kv_index``)."""
    width = hq * hd // n
    c0, c1 = i * width, (i + 1) * width
    q0, q1 = c0 // hd, -(-c1 // hd)
    group = hq // hkv
    kv0, kv1 = q0 // group, (q1 - 1) // group + 1
    nq = q1 - q0
    whole_groups = q0 % group == 0 and nq % group == 0
    kv_index = None if whole_groups or kv1 - kv0 == 1 else tuple(
        h // group - kv0 for h in range(q0, q1))
    return HeadPlan(q0, q1, kv0, kv1, kv_index, c0 - q0 * hd, c1 - q0 * hd)


# -- the vocabulary-parallel cross entropy --------------------------------------


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor, v0: int,
                       t: TP) -> torch.Tensor:
    """The negative log-likelihood of ``labels`` (any shape, global ids)
    under logits whose last dim holds this rank's vocabulary block
    ``[v0, v0 + V_l)``: the max and the sum of exps are all-reduced over
    the axis, and the label's logit comes from the rank that holds it.
    The same on every rank; differentiable in ``logits``."""
    logits = logits.float()
    with torch.no_grad():
        top = logits.amax(dim=-1)
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=t.group)
    shifted = logits - top[..., None]
    sumexp = reduce_from(shifted.exp().sum(dim=-1), t)
    local = labels.long() - v0
    held = (local >= 0) & (local < logits.shape[-1])
    gold = torch.gather(shifted, -1,
                        local.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
    gold = reduce_from(gold * held, t)
    return sumexp.log() - gold
