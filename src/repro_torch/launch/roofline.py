"""Roofline terms of one (arch × shape × mesh) cell, for one NVIDIA H100
a rank.

Three terms, as the reference's ``src/repro/launch/roofline.py`` has
them:

  compute    = analytic_FLOPs / (ranks × peak_FLOPs)             [s]
  memory     = analytic_HBM_bytes / (ranks × HBM_bandwidth)      [s]
  collective = collective_operand_bytes_per_rank / link_bw       [s]

FLOPs and bytes are analytic (``launch/estimate.py``).  The rates are
the H100 SXM data sheet's (dense bf16 tensor cores, HBM3, and NVLink's
900 GB/s both ways, 450 GB/s each way); none of them is measured here,
and one card cannot measure the link.

torch gives no compiled program to parse, so the collective bytes come
from ``CommDebugMode``: :func:`collectives` runs the port's own sharded
step (``sharding.place``'s per-use gathers, their reduce-scatters in the
backward, the tensor-parallel all-reduces, gathers and reduce-scatters
of ``sharding.tp`` on the ``model`` axis, the MoE's all-to-alls) on the
``meta`` device under a fake process group of the mesh's size, at one
and at two units of depth (a layer; an sLSTM or attention superblock for
ssm and hybrid), counts each collective and its operand bytes on rank 0,
and extrapolates linearly to the config's depth.  A tensor-parallel pass
of ssm or hybrid, whose mixers loop over chunks (and the sLSTM over
tokens) in Python, is counted at two short lengths and extrapolated
linearly to the shape's, as its depth is.  Where an op of the pass cannot run on
the meta device, the term is reported unavailable with the reason,
never invented.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Optional

import torch

__all__ = ["HW", "RooflineTerms", "analyze", "collectives"]


@dataclasses.dataclass(frozen=True)
class HW:
    peak_flops: float = 989e12      # dense bf16 FLOP/s (H100 SXM sheet)
    hbm_bw: float = 3.35e12         # HBM3 bytes/s (H100 SXM sheet)
    link_bw: float = 450e9          # NVLink bytes/s each way (sheet)


_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
          "collective-permute", "broadcast")
#: c10d ops whose first argument is the output: the operand is the second
_OUTPUT_FIRST = ("allgather_", "_allgather_base_", "allgather_coalesced_",
                 "allgather_into_tensor_coalesced_", "reduce_scatter_",
                 "_reduce_scatter_base_", "reduce_scatter_tensor_coalesced_",
                 "alltoall_", "alltoall_base_", "recv_", "recv_any_source_")


#: the op namespaces of c10d's collectives and of the functional ones
_COMM_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional",
                    "_c10d_functional_autograd", "_dtensor")


def _kind(name: str) -> Optional[str]:
    if "gather" in name:
        return "all-gather"
    if "reduce_scatter" in name:
        return "reduce-scatter"
    if "all_reduce" in name or "allreduce" in name:
        return "all-reduce"
    if "all_to_all" in name or "alltoall" in name:
        return "all-to-all"
    if name.startswith("send"):
        return "collective-permute"
    if "broadcast" in name:
        return "broadcast"
    return None                       # recv: counted at its send


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


def _comm_mode():
    """A ``CommDebugMode`` that also sums each collective's operand
    bytes by kind."""
    from torch.distributed.tensor.debug import CommDebugMode

    class CommBytes(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.bytes = defaultdict(int)
            self.ops = defaultdict(int)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            packet = getattr(func, "_overloadpacket", None)
            if packet is not None and func.namespace in _COMM_NAMESPACES:
                name = packet.__name__
                kind = _kind(name)
                if kind is not None:
                    operand = (args[1] if name in _OUTPUT_FIRST
                               and len(args) > 1 else args[0])
                    self.bytes[kind] += _nbytes(operand)
                    self.ops[kind] += 1
            return super().__torch_dispatch__(func, types, args, kwargs)

    return CommBytes()


def _depth(cfg, k: int):
    """``cfg`` cut to ``k`` units of depth, and the config's own number
    of units."""
    if cfg.family == "ssm":
        unit = cfg.slstm_every
    elif cfg.family == "hybrid":
        unit = cfg.attn_every
    else:
        unit = 1
    over = {"n_layers": unit * k}
    if cfg.family == "audio":
        over["encoder_layers"] = k
    return dataclasses.replace(cfg, **over), cfg.n_layers / unit


#: the sequence of a non-MoE pass (see ``_one_pass``), and the shorter of
#: the two a recurrent tensor-parallel pass is counted at (``_counted``)
_SHORT_SEQ = 256


def _one_pass(cfg, shape, mesh, specs: dict, batch_spec: dict) -> tuple:
    """(bytes by kind, ops by kind) of one step of ``cfg`` on rank 0:
    the train step's loss and gradients, the prefill's last-position
    logits, or one decode step (on a cache placed as ``prefill`` places
    it), on this rank's rows of the batch.  Where neither the MoE nor
    tensor parallelism moves activations, the sharded step moves weights
    and their gradients only (the loss's all-reduce is a scalar), so a
    train or prefill pass runs at no more than ``_SHORT_SEQ`` positions:
    the recurrent families' token-by-token scans would take minutes on
    the meta device at 32k."""
    from ..models import transformer
    from ..models.io import batch_specs, place_cache
    from ..sharding import place
    from ..training.train_step import mesh_loss

    computes_tp = _computes_tp(specs)
    if not cfg.is_moe and not computes_tp and shape.kind != "decode":
        # weights only: the collectives do not depend on the sequence
        shape = dataclasses.replace(
            shape, seq_len=min(shape.seq_len, _SHORT_SEQ))
    model = transformer.init_params(cfg, torch.Generator(), device="meta")
    place.distribute_model(model, specs, mesh)
    batch = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
             for k, v in batch_specs(cfg, shape).items()}
    spec = batch_spec["tokens"]
    entry = spec[0] if spec else None
    axes = tuple(a for a in (entry if isinstance(entry, tuple)
                             else (entry,)) if a is not None)
    rows = {k: place.local_rows(v, mesh, batch_spec[k])
            for k, v in batch.items()}
    mode = _comm_mode()
    with mode, place.batch_axes(axes):
        if shape.kind == "train":
            model.requires_grad_(True)
            _, share = mesh_loss(cfg, model, batch, mesh, with_local=True,
                                 axes=axes)
            torch.autograd.grad(share, list(model.parameters()),
                                allow_unused=True)
        elif shape.kind == "prefill":
            with torch.no_grad():
                transformer.forward(cfg, model, rows, last_only=True)
        else:
            cache = transformer.init_cache(cfg, rows["tokens"].shape[0],
                                           shape.seq_len, device="meta")
            if computes_tp:
                cache = place_cache(cfg, cache, mesh, device="meta")
            cache["pos"] = shape.seq_len - 1
            transformer.decode_step(cfg, model, cache, rows["tokens"])
    return dict(mode.bytes), dict(mode.ops)


def _computes_tp(specs: dict) -> bool:
    """Some weight computes on its ``model`` block (``tp.axis_of``)."""
    from ..sharding.rules import model_role

    return any(model_role(n, s) for n, s in specs.items())


def _counted(cfg, shape, mesh, specs: dict, batch_spec: dict) -> tuple:
    """:func:`_one_pass`; for a tensor-parallel train or prefill pass of
    ssm or hybrid, whose activations' collectives grow with the sequence,
    counted at ``_SHORT_SEQ`` and twice that and extrapolated linearly to
    the shape's length: the meta device would take minutes over the
    token-by-token sLSTM and the chunk loops at 32k."""
    two = 2 * _SHORT_SEQ
    if (cfg.family not in ("ssm", "hybrid") or shape.kind == "decode"
            or shape.seq_len <= two or not _computes_tp(specs)):
        return _one_pass(cfg, shape, mesh, specs, batch_spec)
    lo, hi = (_one_pass(cfg, dataclasses.replace(shape, seq_len=n), mesh,
                        specs, batch_spec) for n in (_SHORT_SEQ, two))
    f = (shape.seq_len - _SHORT_SEQ) / (two - _SHORT_SEQ)
    return tuple({k: a.get(k, 0) + (b.get(k, 0) - a.get(k, 0)) * f
                  for k in set(a) | set(b)} for a, b in zip(lo, hi))


def collectives(cfg, shape, mesh, param_spec_fn, batch_spec: dict) -> dict:
    """``{"bytes": {kind: bytes}, "ops": {kind: n}}`` a rank moves in
    one step of ``cfg`` at its depth, or ``{"unavailable": reason}``.
    ``param_spec_fn(cfg)`` gives the specs of a config cut in depth."""
    try:
        counts = []
        for k in (1, 2):
            cut, units = _depth(cfg, k)
            counts.append(_counted(cut, shape, mesh, param_spec_fn(cut),
                                   batch_spec))
    except Exception as e:  # an op with no meta kernel or DTensor rule
        return {"unavailable": f"{type(e).__name__}: {e}"[:300]}
    out = {}
    for i, what in enumerate(("bytes", "ops")):
        one, two = counts[0][i], counts[1][i]
        out[what] = {
            kind: max(0.0, one.get(kind, 0) + (two.get(kind, 0)
                                               - one.get(kind, 0))
                      * (units - 1))
            for kind in _KINDS}
    return out


@dataclasses.dataclass
class RooflineTerms:
    flops_global: float                 # analytic
    hbm_bytes_global: float             # analytic
    coll_bytes_per_device: Optional[float]
    coll_breakdown: dict
    compute_s: float
    memory_s: float
    collective_s: Optional[float]
    dominant: str
    roofline_fraction: float            # compute_s / max(terms)
    model_flops: float = 0.0            # 6·N·D convention (useful)
    useful_ratio: float = 0.0           # model_flops / analytic flops

    def to_dict(self):
        return dataclasses.asdict(self)


def analyze(n_ranks: int, coll: dict, hw: HW = HW(),
            model_flops: float = 0.0,
            estimate: Optional[dict] = None) -> RooflineTerms:
    """The three terms from ``estimate`` (``cell_estimate``'s global
    flops and bytes) and ``coll`` (:func:`collectives`'s)."""
    compute_s = estimate["flops"] / (n_ranks * hw.peak_flops)
    memory_s = estimate["hbm_bytes"] / (n_ranks * hw.hbm_bw)
    terms = [("compute", compute_s), ("memory", memory_s)]
    if "unavailable" in coll:
        cbytes = collective_s = None
        breakdown = {"unavailable": coll["unavailable"]}
    else:
        cbytes = float(sum(coll["bytes"].values()))
        collective_s = cbytes / hw.link_bw
        breakdown = {**coll["bytes"], "_counts": coll["ops"]}
        terms.append(("collective", collective_s))
    dominant = max(terms, key=lambda kv: kv[1])[0]
    peak = max(max(t for _, t in terms), 1e-12)
    useful = model_flops / estimate["flops"] if estimate["flops"] else 0.0
    return RooflineTerms(
        flops_global=estimate["flops"],
        hbm_bytes_global=estimate["hbm_bytes"],
        coll_bytes_per_device=cbytes, coll_breakdown=breakdown,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, roofline_fraction=compute_s / peak,
        model_flops=model_flops, useful_ratio=useful)
