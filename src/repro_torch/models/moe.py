"""Mixture-of-Experts layer: top-k routing with capacity-bounded,
index-based dispatch.

The port of ``moe_init``, ``moe_capacity`` and ``moe_apply`` of
``src/repro/models/moe.py``, with the same semantics, per batch row:

  1. f32 router softmax, top-k gates, renormalised;
  2. position-in-expert from a stable sort of the flat expert choices
     (rank within each expert's segment);
  3. choices past the capacity are dropped into an extra bucket row (the
     residual path carries them);
  4. tokens gathered into (B, E, C, D), the expert SwiGLU batched over
     the expert dim, each kept choice's output weighted and summed back.

``torch.argsort(..., stable=True)``, ``scatter_add_``, ``scatter_`` and
``gather`` take the place of the reference's ``.at[]`` updates.

With ``moe_shard`` "ep" or "ep_infer", a mesh set (:func:`set_mesh`) and
the experts dividing its ``model`` axis, ``moe_apply`` runs
:func:`moe_apply_ep`, the reference's ``shard_map`` body as per-rank
code: each rank routes its own tokens, and ``all_to_all_single`` over the
mesh's ``model`` group moves them to their experts' rank and back.
Otherwise it runs the plain dispatch, as the reference does.  On a
tensor-parallel model (``t``, :mod:`repro_torch.sharding.tp`) whose
experts' d_ff the ``model`` axis shards (``n_experts`` does not divide
it), the plain dispatch runs tensor-parallel inside the experts: every
rank routes all of the tokens alike, and computes its block of d_ff of
each expert (w1/w3 column-, w2 row-parallel); the partial combine is
all-reduced, or reduce-scattered along the sequence under ``seq``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..sharding import place, tp
from ..sharding.tp import _group
from .layers import Params, dense_init, raw

__all__ = ["moe_init", "moe_apply", "moe_apply_ep", "moe_capacity",
           "moe_route", "set_mesh"]


def moe_init(generator: torch.Generator, cfg, dtype) -> Params:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return Params(
        router=dense_init(generator, (d, e), dtype=torch.float32),
        w1=dense_init(generator, (e, d, f), dtype=dtype),
        w3=dense_init(generator, (e, d, f), dtype=dtype),
        w2=dense_init(generator, (e, f, d), dtype=dtype),
    )


def moe_capacity(cfg, seq_len: int) -> int:
    cap = int(seq_len * cfg.experts_per_token * cfg.capacity_factor
              / cfg.n_experts)
    return max(cap, cfg.experts_per_token)


def _ep_constraint(cfg, t):
    """Pin a (B, E, C, D) DTensor dispatch/combine buffer onto the
    ``model`` axis by its expert dim (``moe_shard="ep"``), as the
    reference's ``with_sharding_constraint``; the identity on a plain
    tensor, which is what the port's plain dispatch holds."""
    if cfg.moe_shard != "ep" or not place.is_dtensor(t):
        return t
    from torch.distributed.tensor import Shard

    names = t.device_mesh.mesh_dim_names
    if "model" not in names:
        return t
    placements = list(t.placements)
    placements[names.index("model")] = Shard(1)
    return t.redistribute(t.device_mesh, placements)


def moe_route(p, cfg, x: torch.Tensor, capacity: int,
              router: Optional[torch.Tensor] = None):
    """Routing of x (B, S, D): the renormalised top-k gates (B, S, k), and
    for each flat choice (B, S * k) its expert, whether it is kept, and
    its slot (``expert * capacity + position``, or ``E * capacity``, the
    drop bucket, where it is not kept)."""
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    router = p["router"] if router is None else router
    logits = x.float() @ router.float()
    gates = torch.softmax(logits, dim=-1)                      # (B, S, E)
    topv, topi = torch.topk(gates, k, dim=-1)                  # (B, S, k)
    topv = topv / topv.sum(dim=-1, keepdim=True)               # renormalize

    # position-in-expert by stable sort of flat choices (per batch row)
    ef = topi.reshape(b, s * k)                                # (B, S*k)
    order = torch.argsort(ef, dim=1, stable=True)
    sorted_e = torch.gather(ef, 1, order)
    counts = torch.zeros((b, e), dtype=ef.dtype, device=x.device)
    counts.scatter_add_(1, ef, torch.ones_like(ef))
    starts = counts.cumsum(dim=1) - counts                     # exclusive
    pos_sorted = (torch.arange(s * k, device=x.device)[None, :]
                  - torch.gather(starts, 1, sorted_e))
    pos = torch.empty_like(ef).scatter_(1, order, pos_sorted)

    keep = pos < capacity
    slot = torch.where(keep, ef * capacity + pos,
                       torch.full_like(ef, e * capacity))     # drop bucket
    return topv, ef, keep, slot


def moe_apply(p, cfg, x: torch.Tensor, capacity: Optional[int] = None,
              *, t: Optional[tp.TP] = None, seq: bool = False
              ) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D).  Batched index-based dispatch; the
    "ep" / "ep_infer" policies switch to the all-to-all path when a mesh
    is set and the experts divide its ``model`` axis.  With ``t``, x is
    this rank's block of the sequence under ``seq`` (module
    docstring)."""
    if (cfg.moe_shard in ("ep", "ep_infer") and _MESH is not None
            and cfg.n_experts % place.mesh_coordinate(_MESH, "model")[0]
            == 0):
        return moe_apply_ep(p, cfg, x, seq=seq)
    if tp.sharded(t, raw(p, "w1"), 2) and tp.sharded(t, raw(p, "w3"), 2) \
            and tp.sharded(t, raw(p, "w2"), 1):
        return _moe_tp(p, cfg, x, capacity, t, seq)
    return tp.whole(lambda x: _dispatch(p, cfg, x, capacity), x, t, seq)


def _moe_tp(p, cfg, x: torch.Tensor, capacity: Optional[int], t: tp.TP,
            seq: bool) -> torch.Tensor:
    """Tensor parallelism inside the experts (module docstring).  The
    routing is the same on every rank (its gradient needs no sum); the
    gates meet partial expert outputs, so theirs does (``copy_to``)."""
    route = tp.gather(x, 1, t) if seq else x
    xin = tp.gather_sum(x, 1, t) if seq else tp.copy_to(x, t)
    topv, _, keep, slot = moe_route(
        None, cfg, route, capacity or moe_capacity(cfg, route.shape[1]),
        router=place.local(raw(p, "router")))
    weights = {name: place.local(raw(p, name), keep_model=True)
               for name in ("w1", "w3", "w2")}
    out = _dispatch(weights, cfg, xin, capacity,
                    routing=(tp.copy_to(topv, t), keep, slot))
    return tp.reduce_scatter(out, 1, t) if seq else tp.reduce_from(out, t)


def _dispatch(p, cfg, x: torch.Tensor, capacity: Optional[int] = None,
              routing: Optional[tuple] = None) -> torch.Tensor:
    """The plain dispatch of x (B, S, D), routed by ``routing`` (the
    gates, kept mask and slots of :func:`moe_route`) or by ``p``'s
    router."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    capacity = capacity or moe_capacity(cfg, s)
    if routing is None:
        topv, _, keep, slot = moe_route(p, cfg, x, capacity)
    else:
        topv, keep, slot = routing

    # dispatch: (B, E*C+1, D) buffer; the last row swallows drops
    token_of_choice = torch.arange(s, device=x.device).repeat_interleave(k)
    idx = slot[..., None].expand(b, s * k, d)
    xin = torch.zeros((b, e * capacity + 1, d), dtype=x.dtype,
                      device=x.device)
    xin.scatter_(1, idx, x[:, token_of_choice])
    xin = _ep_constraint(cfg, xin[:, :-1].reshape(b, e, capacity, d))

    # expert SwiGLU, batched over the expert dim
    h = F.silu(torch.einsum("becd,edf->becf", xin, p["w1"])) * torch.einsum(
        "becd,edf->becf", xin, p["w3"])
    y = _ep_constraint(cfg, torch.einsum("becf,efd->becd", h, p["w2"]))

    # combine: gather each kept choice's output, weight, sum over k
    y_flat = torch.cat([y.reshape(b, e * capacity, d),
                        torch.zeros((b, 1, d), dtype=y.dtype,
                                    device=y.device)], dim=1)
    w = topv.reshape(b, s * k)[..., None].to(y.dtype) * keep[..., None]
    per_choice = torch.gather(y_flat, 1, idx) * w
    return per_choice.reshape(b, s, k, d).sum(dim=2)


# ---------------------------------------------------------------------------
# Expert-parallel MoE (all-to-all dispatch), per rank
# ---------------------------------------------------------------------------
#
# The reference's ``shard_map`` body, run by every rank of the mesh on its
# own tokens: rank (data i, model j) holds its batch rows (the sharded
# step's; all rows where the batch does not divide 'data') over the whole
# sequence, the same on every rank of the model axis.  It takes the j-th
# 1/|model| of the sequence (all of it where S does not divide 'model':
# decode), routes those tokens locally with the local capacity
# max(k, int(t·k·cf/E)) -> dispatch (E, C_l, D) -> all_to_all over
# 'model' regroups to (E/|model|, |model|·C_l, D) -> expert FFN on its
# E/|model| experts (DTensor weights all-gathered over 'data' on entry
# for "ep": FSDP) -> reverse all_to_all -> local combine -> all-gather of
# the sequence over 'model'.  An axis of one rank moves nothing.

_MESH = None  # set by launchers and the sharded step (see launch/train.py)


def set_mesh(mesh) -> None:
    global _MESH
    _MESH = mesh


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of equal blocks along dim 0; its gradient is
    the same exchange of the gradient's blocks."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        torch.distributed.all_to_all_single(out, x.contiguous(),
                                            group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        torch.distributed.all_to_all_single(out, g.contiguous(),
                                            group=ctx.group)
        return out, None


def _experts(w, n_model: int, j: int, token_axes: tuple):
    """This rank's E/|model| experts of ``w``, whole in their other dims.
    A DTensor is gathered over every axis but 'model' (the FSDP gather
    of "ep"), its gradient a partial sum over the axes whose ranks route
    other tokens; a plain tensor holds every expert whole."""
    if not place.is_dtensor(w):
        return w.chunk(n_model, dim=0)[j]
    return place.local(w, token_axes, keep_model=True)


def moe_apply_ep(p, cfg, x: torch.Tensor, seq: bool = False
                 ) -> torch.Tensor:
    """x: (B_l, S, D) -> (B_l, S, D), the explicit expert-parallel
    all-to-all over the mesh of :func:`set_mesh`.  ``x`` is this rank's
    rows (see above), or under ``seq`` (a sequence-parallel residual)
    this rank's block of their sequence already, which it routes as is.  The weights' placement carries the reference's
    ``fsdp_weights``: "ep" places them over 'data' too (the training
    specs) and they are gathered on entry; "ep_infer" places them by
    expert only (the inference specs).  Either way each rank computes
    with its experts whole, so the values do not depend on it."""
    mesh = _MESH
    if mesh is None:
        raise RuntimeError("moe_shard='ep' needs set_mesh(...)")
    n_model, j, g_model = _group(mesh, "model")
    e, k = cfg.n_experts, cfg.experts_per_token
    if e % n_model:
        raise ValueError(f"{e} experts do not divide the model axis "
                         f"({n_model})")
    _, s_all, d = x.shape
    split = not seq and s_all % n_model == 0 and n_model > 1
    batch_axes = place.current_batch_axes()
    # the mesh axes whose ranks hold other tokens than this rank's
    token_axes = tuple(a for a in ("data",) if a in batch_axes) + (
        ("model",) if split or seq else ())
    axis = tp.TP(n_model, j, g_model)
    xb = tp.split(x, 1, axis) if split else x
    b_l, s_l, _ = xb.shape
    t = b_l * s_l
    cap = max(k, int(t * k * cfg.capacity_factor / e))

    router = place.local(raw(p, "router"), token_axes)
    topv, ef, keep, slot = moe_route(None, cfg, xb.reshape(1, t, d), cap,
                                     router=router)
    topv, ef, keep, slot = (topv.reshape(t, k), ef.reshape(-1),
                            keep.reshape(-1), slot.reshape(-1))

    tok = torch.arange(t, device=x.device).repeat_interleave(k)
    xt = xb.reshape(t, d)
    idx = slot[:, None].expand(t * k, d)
    xin = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    xin = xin.scatter(0, idx, xt[tok])
    xin = xin[:-1].reshape(e, cap, d)

    # ship token blocks to their expert's model rank: block r of the
    # experts goes to rank r; what arrives is (sources, E_l, cap, D)
    e_l = e // n_model
    if n_model > 1:
        xin = _AllToAll.apply(xin, g_model)
    xin = xin.reshape(n_model, e_l, cap, d).transpose(0, 1).reshape(
        e_l, n_model * cap, d)

    w1, w3, w2 = (_experts(raw(p, name), n_model, j, token_axes)
                  for name in ("w1", "w3", "w2"))
    h = F.silu(torch.einsum("ecd,edf->ecf", xin, w1)) * torch.einsum(
        "ecd,edf->ecf", xin, w3)
    y = torch.einsum("ecf,efd->ecd", h, w2)                  # (E_l, n*cap, D)

    # ship results back to the owning token rank
    y = y.reshape(e_l, n_model, cap, d).transpose(0, 1).contiguous()
    if n_model > 1:
        y = _AllToAll.apply(y, g_model)
    y = y.reshape(e * cap, d)                                 # (E*cap, D)

    y_flat = torch.cat([y, torch.zeros((1, d), dtype=y.dtype,
                                       device=y.device)], dim=0)
    out = y_flat[slot] * (topv.reshape(-1)[:, None].to(y.dtype)
                          * keep[:, None])
    out = out.reshape(t, k, d).sum(dim=1).reshape(b_l, s_l, d)
    return tp.gather(out, 1, axis) if split else out
