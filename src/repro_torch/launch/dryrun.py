"""Dry-run of every (arch × shape × mesh) cell, with no devices.

The port of ``src/repro/launch/dryrun.py``.  Where the reference lowers
and compiles each cell's step for 512 placeholder XLA devices, this runs
on the ``meta`` device under a fake process group of 256 or 512 ranks
(``torch.testing``'s ``FakeStore``, backend ``"fake"``): nothing is
compiled, so there is no ``memory_analysis`` (no peak or temporary
bytes, no proof of fit).  Per cell it records the bytes a rank holds of
its arguments (parameters, AdamW moments, batch and decode cache, from
the placements of ``sharding.rules``), the analytic FLOPs and bytes of
``launch/estimate.py``, the H100 roofline terms of ``launch/roofline.py``
(the collective term from ``CommDebugMode`` over the port's own sharded
step on meta tensors: tensor-parallel on the ``model`` axis for dense,
vlm and moe; an inference cell with the inference specs, which shard
weights on ``model`` only, and its decode cache placed by
``rules.cache_pspec``, as the reference lowers them), and the
sharding-rule fallbacks, as one JSON file; re-runs skip cells whose JSON
already exists.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch all]
      [--shape all] [--mesh both] [--out results/dryrun_torch] [--force]

A process runs one fake group at a time, and none beside another
process group: :func:`run_cell` starts and ends its own.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch.distributed as dist

from ..configs import ARCH_IDS, SHAPES, ShapeConfig, get_config
from ..models import moe
from ..models.io import batch_specs, cache_specs
from ..models.transformer import param_shapes
from ..sharding import rules
from .estimate import cell_estimate
from .mesh import make_local_mesh, make_production_mesh
from .roofline import HW, analyze, collectives

__all__ = ["run_cell", "cell_is_applicable", "model_flops", "auto_flags",
           "rank_bytes", "main"]


def cell_is_applicable(cfg, shape) -> tuple[bool, str]:
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("long_500k needs sub-quadratic attention; "
                       f"{cfg.name} is full-attention (see DESIGN.md)")
    return True, ""


def model_flops(cfg, shape) -> float:
    """6·N·D (train) / 2·N·D (inference); N from the real parameter
    shapes, MoE experts scaled to the active top-k."""
    total = 0.0
    for name, leaf in param_shapes(cfg).items():
        ps = name.replace(".", "/")
        if ps.endswith("embed") and not cfg.tied_embeddings:
            continue  # input embedding is a lookup, not a matmul
        n = leaf.size
        if "/moe/w" in ps:
            n = n * cfg.experts_per_token / cfg.n_experts
        total += n
    tokens = shape.global_batch * (
        1 if shape.kind == "decode" else shape.seq_len)
    mult = 6 if shape.kind == "train" else 2
    return mult * total * tokens


def auto_flags(cfg, shape, n_chips: int = 256) -> dict:
    """Per-cell optimization policy of the reference's hillclimb:

    * blocked attention always (O(S) memory, no score collectives);
    * EP all-to-all MoE whenever experts divide the model axis;
    * sequence-parallel activations for inference cells and for archs whose
      heads cannot shard the model axis (yi/whisper) or that use EP-MoE —
      but NOT for divisible-head dense training;
    * small models train pure-DP + ZeRO-1 (replicated weights, the batch
      over the whole mesh).
    """
    n_model = 16
    heads_div = cfg.n_kv_heads % n_model == 0 or cfg.n_heads % n_model == 0
    ep_ok = cfg.is_moe and cfg.n_experts % n_model == 0
    moe_blocks_sp = cfg.is_moe and not ep_ok
    n_params = sum(l.size for l in param_shapes(cfg).values())
    dp_only = (shape.kind == "train"
               and shape.global_batch % n_chips == 0
               and n_params * 6.5 < 14e9)
    if moe_blocks_sp or dp_only:
        act = None
    elif shape.kind == "train" and cfg.family in ("ssm", "hybrid"):
        act = None
    elif shape.kind != "train" or not heads_div or ep_ok:
        act = "seq_model"
    else:
        act = None
    return dict(impl="blocked", act_shard=act,
                moe_shard="ep" if ep_ok else None,
                dp_only=dp_only,
                infer_params_like_train=moe_blocks_sp)


def _bytes(shape: tuple, itemsize: int, spec: tuple, sizes: dict) -> int:
    n = itemsize
    for dim, size in enumerate(shape):
        entry = spec[dim] if dim < len(spec) else None
        parts = 1
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                parts *= sizes[axis]
        n *= -(-size // parts)
    return n


def _specs(cfg, shape, mesh, infer_like_train: bool, dp_only: bool):
    p_sds = param_shapes(cfg)
    p_spec = rules.param_specs(
        cfg, p_sds, mesh, training=shape.kind == "train" or infer_like_train,
        tp=not dp_only)
    return p_sds, p_spec


def rank_bytes(cfg, shape, mesh, *, infer_like_train: bool = False,
               dp_only: bool = False) -> dict:
    """Bytes one rank holds of each argument of the cell's step: the
    parameters, the AdamW moments (f32 ``m`` and ``v`` and the int32
    step; train cells), the batch and the decode cache, by the
    placements of ``sharding.rules``."""
    sizes = rules.axis_sizes(mesh)
    p_sds, p_spec = _specs(cfg, shape, mesh, infer_like_train, dp_only)
    out = {"param_bytes_per_device": sum(
        _bytes(l.shape, l.dtype.itemsize, p_spec[n], sizes)
        for n, l in p_sds.items())}
    if shape.kind == "train":
        o_spec = rules.opt_pspec(p_spec, shapes=p_sds, mesh=mesh,
                                 zero1=dp_only)
        out["opt_bytes_per_device"] = 4 + sum(
            _bytes(p_sds[n].shape, 4, o_spec[k][n], sizes)
            for k in ("m", "v") for n in p_sds)
    b_spec = rules.batch_specs_pspec(cfg, shape, mesh, all_axes=dp_only)
    out["batch_bytes_per_device"] = sum(
        _bytes(l.shape, l.dtype.itemsize, b_spec[k], sizes)
        for k, l in batch_specs(cfg, shape).items())
    if shape.kind == "decode":
        c_sds = cache_specs(cfg, shape)
        c_spec = rules.cache_pspec(cfg, shape, mesh, c_sds)
        out["cache_bytes_per_device"] = sum(
            _bytes(l.shape, l.dtype.itemsize, c_spec[k], sizes)
            for k, l in c_sds.items())
    out["argument_bytes_per_device"] = sum(out.values())
    return out


def _fake_mesh(n_ranks: int, mesh_shape: tuple | None, multi_pod: bool):
    """The cell's mesh over a fake process group of its size, rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_ranks)
    if mesh_shape:
        return make_local_mesh(*mesh_shape, device="cpu")
    return make_production_mesh(multi_pod=multi_pod, device="cpu")


def run_cell(arch: str, shape_name, multi_pod: bool, hw: HW = HW(),
             impl: str | None = None, act_shard: str | None = None,
             moe_shard: str | None = None, auto_opt: bool = False,
             mesh_shape: tuple | None = None, cfg=None) -> dict:
    """One cell's record.  ``shape_name`` is a key of ``SHAPES`` or a
    ``ShapeConfig``; ``mesh_shape`` (data, model) replaces the
    production mesh; ``cfg`` replaces ``get_config(arch)``."""
    if dist.is_initialized():
        raise RuntimeError("run_cell starts its own fake process group: "
                           "run it in a process without one")
    cfg = cfg or get_config(arch)
    shape = (shape_name if isinstance(shape_name, ShapeConfig)
             else SHAPES[shape_name])
    infer_like_train = dp_only = False
    if mesh_shape is not None:
        mesh_name = "x".join(map(str, mesh_shape))
        n_ranks = mesh_shape[0] * mesh_shape[1]
    else:
        mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
        n_ranks = 512 if multi_pod else 256
    if auto_opt:
        flags = auto_flags(cfg, shape, n_chips=n_ranks)
        impl = impl or flags["impl"]
        act_shard = act_shard or flags["act_shard"]
        moe_shard = moe_shard or flags["moe_shard"]
        infer_like_train = flags.get("infer_params_like_train", False)
        dp_only = flags.get("dp_only", False)
    if impl:
        cfg = dataclasses.replace(cfg, attention_impl=impl)
    if act_shard:
        cfg = dataclasses.replace(cfg, act_shard=act_shard)
    if moe_shard:
        if moe_shard == "ep" and shape.kind != "train":
            moe_shard = "ep_infer"  # inference weights are not FSDP-sharded
        cfg = dataclasses.replace(cfg, moe_shard=moe_shard)
    result = {"arch": arch, "shape": shape.name, "mesh": mesh_name,
              "attention_impl": cfg.attention_impl}
    ok, why = cell_is_applicable(cfg, shape)
    if not ok:
        result.update(status="skipped", reason=why)
        return result
    try:
        t0 = time.time()
        mesh = _fake_mesh(n_ranks, mesh_shape, multi_pod)
        moe.set_mesh(mesh)
        memory = rank_bytes(cfg, shape, mesh,
                            infer_like_train=infer_like_train,
                            dp_only=dp_only)
        fallbacks = rules.fallback_report()
        b_spec = rules.batch_specs_pspec(cfg, shape, mesh, all_axes=dp_only)
        coll = collectives(
            cfg, shape, mesh,
            lambda c: _specs(c, shape, mesh, infer_like_train, dp_only)[1],
            b_spec)
        terms = analyze(n_ranks, coll, hw, model_flops=model_flops(cfg, shape),
                        estimate=cell_estimate(cfg, shape))
        result.update(
            status="ok", trace_s=round(time.time() - t0, 2),
            n_chips=n_ranks, memory=memory, roofline=terms.to_dict(),
            sharding_fallbacks=fallbacks)
    except Exception as e:  # record the failure, keep sweeping
        result.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-2000:])
    finally:
        moe.set_mesh(None)
        if dist.is_initialized():
            dist.destroy_process_group()
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--impl", default=None,
                    help="attention impl override (reference|blocked|pallas)")
    ap.add_argument("--act-shard", default=None,
                    help="activation sharding policy (none|seq_model)")
    ap.add_argument("--moe-shard", default=None,
                    help="MoE dispatch sharding (none|ep)")
    ap.add_argument("--auto-opt", action="store_true",
                    help="per-cell best flags from the hillclimb policy")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    n_ok = n_err = n_skip = 0
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                tag = f"{arch}__{shape}__{'multi' if multi else 'single'}"
                path = outdir / f"{tag}.json"
                if path.exists() and not args.force:
                    prev = json.loads(path.read_text())
                    print(f"[skip-cached] {tag}: {prev.get('status')}")
                    continue
                print(f"[run] {tag} ...", flush=True)
                res = run_cell(arch, shape, multi, impl=args.impl,
                               act_shard=args.act_shard,
                               moe_shard=args.moe_shard,
                               auto_opt=args.auto_opt)
                path.write_text(json.dumps(res, indent=2, default=str))
                st = res["status"]
                n_ok += st == "ok"
                n_err += st == "error"
                n_skip += st == "skipped"
                extra = ""
                if st == "ok":
                    r = res["roofline"]
                    coll = ("unavailable" if r["collective_s"] is None
                            else f"{r['collective_s']:.4f}s")
                    extra = (f" trace={res['trace_s']}s "
                             f"dominant={r['dominant']} "
                             f"comp={r['compute_s']:.4f}s "
                             f"mem={r['memory_s']:.4f}s coll={coll} "
                             f"arg/rank="
                             f"{res['memory']['argument_bytes_per_device']}")
                elif st == "error":
                    extra = " " + res["error"][:160]
                print(f"[{st}] {tag}{extra}", flush=True)
    print(f"done: ok={n_ok} err={n_err} skipped={n_skip}")


if __name__ == "__main__":
    main()
