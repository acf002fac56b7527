"""Logical-axis sharding rules with divisibility fallback.

Copied from ``src/repro/sharding/rules.py``, on the port's per-layer
parameters.  Each parameter's trailing dims get logical roles from its
path (column-parallel, row-parallel, expert, vocab, ...), which map to
mesh axes.  A proposed mesh axis is dropped (replicated) when the dim
size does not divide the axis size or the axis is already used by another
dim of the same tensor; every fallback is logged for ``fallback_report``.

Mapping summary (single-pod mesh ("data", "model")):
  * column-parallel weights (wq/wk/wv/w1/w3/up-projections):  (data, model)
  * row-parallel weights (wo/w2/down-projections):             (model, data)
  * MoE experts (E, D, F): expert dim on 'model' when E % model == 0
    (expert parallelism), else TP inside the expert on F.
  * embeddings (V, D): vocab on 'model', features on 'data'.
  * norms/gates/biases: replicated.
Activations: batch on ('pod', 'data'); long-context decode KV shards the
sequence on 'data' instead (batch=1).

A spec is a plain tuple with one entry a dim: ``None``, an axis name, or
a tuple of axis names (the reference's ``PartitionSpec`` entries); ``()``
replicates the whole tensor.  Trees are dicts keyed by the port's names.
The reference's parameters are layer-stacked (``layers/attn/wq``, with
leading stack axes); the port's are one tensor a layer
(``layers.0.attn.wq``).  The rules match the port's names written with
``/`` (``layers/0/attn/wq``), so a rule applies to the same trailing dims
in both; :func:`reference_path` names the reference leaf and stack index
of a port parameter.  Two things differ by construction: the fallback
lines name the port's tensors and their per-layer dims, and ZeRO-1
(``opt_pspec(zero1=True)``) shards the first divisible dim of the
per-layer tensor, where the reference may shard its layer axis; the
bytes a rank holds are the same.  ``placements`` turns a spec into
DTensor placements, in place of the reference's ``named``.
"""

from __future__ import annotations

import re

__all__ = [
    "param_specs", "batch_specs_pspec", "cache_pspec", "opt_pspec",
    "placements", "fallback_report", "reference_path", "axis_sizes",
    "model_role",
]

# path-suffix regex -> logical spec for the trailing dims
# (None entries = replicated dim)
_RULES: list[tuple[str, tuple]] = [
    (r"moe/(w1|w3)$", ("expert", "data", "model")),   # (E, D, F)
    (r"moe/w2$", ("expert", "model", "data")),        # (E, F, D)
    (r"moe/router$", ("data", "model_if_div")),       # (D, E)
    (r"(^|/)embed$", ("model", "data")),              # (V, D)
    (r"lm_head$", ("data", "model")),                 # (D, V)
    (r"(wq|wk|wv|w1|w3|wu|wz|w_in|w)$", ("data", "model")),
    (r"(wo|w2|w_out)$", ("model", "data")),
    (r"(wb|wc|wdt|wi|wf)$", ("data", None)),          # small output dims
    (r"conv$", (None, "model")),                      # (4, Di)
    (r"(^|/)r$", (None, None, None)),                 # slstm recurrent blocks
]


def reference_path(name: str) -> tuple:
    """(the reference's leaf path, the index on its stack axes) of the
    port's parameter ``name``: ``layers.3.attn.wq`` is ``layers/attn/wq``
    at (3,), ``mamba_sb.1.2.w_in`` is ``mamba_sb/w_in`` at (1, 2)."""
    parts = name.split(".")
    return ("/".join(p for p in parts if not p.isdigit()),
            tuple(int(p) for p in parts if p.isdigit()))


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` or an abstract mesh."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


class _FallbackLog:
    def __init__(self):
        self.events: list[str] = []

    def add(self, path, dim, axis, size, axis_size):
        self.events.append(
            f"{path} dim{dim}: {size} % {axis}({axis_size}) != 0 -> replicated")


_LAST_REPORT = _FallbackLog()


def fallback_report() -> list[str]:
    return list(_LAST_REPORT.events)


def _sanitize(spec: tuple, shape: tuple, sizes: dict, path: str,
              log) -> tuple:
    """Drop non-divisible / duplicate axes; prepend Nones for the dims the
    rule does not name."""
    n_lead = len(shape) - len(spec)
    if n_lead < 0:  # rule longer than the tensor (e.g. scalars) -> replicate
        return ()
    out: list = [None] * n_lead
    used: set = set()
    for dim, role in enumerate(spec):
        size = shape[n_lead + dim]
        axis = None
        if role in ("data", "model", "expert", "model_if_div"):
            axis = {"expert": "model", "model_if_div": "model"}.get(role, role)
        if axis is None or axis not in sizes:
            out.append(None)
            continue
        axis_size = sizes[axis]
        if axis in used or size % axis_size != 0:
            if axis not in used:
                log.add(path, n_lead + dim, axis, size, axis_size)
            out.append(None)
            continue
        used.add(axis)
        out.append(axis)
    return tuple(out)


def model_role(name: str, spec: tuple):
    """How the tensor-parallel path computes with the weight ``name``
    placed by ``spec``: "column" (``model`` on its last, output dim),
    "row" (on its input dim), "vocab" (the embedding's vocabulary),
    "expert" (a MoE weight's expert dim), or None (replicated on
    ``model``)."""
    dims = [d for d, e in enumerate(spec)
            if e == "model" or (isinstance(e, tuple) and "model" in e)]
    if not dims:
        return None
    if re.search(r"(^|[./])embed$", name):
        return "vocab"
    return {len(spec) - 1: "column", len(spec) - 2: "row"}.get(
        dims[0], "expert")


def _moe_expert_div(cfg, sizes) -> bool:
    return cfg.is_moe and cfg.n_experts % sizes["model"] == 0


def param_specs(cfg, shapes: dict, mesh, *, training: bool = True,
                tp: bool = True) -> dict:
    """``{name: spec}`` for ``shapes`` (``param_shapes(cfg)``, or any
    dict of named tensors).

    ``training=False`` drops the FSDP 'data' proposals: inference has no
    optimizer state to shard.  ``tp=False`` replicates every weight
    (pure data parallelism; the moments are sharded separately, ZeRO-1
    style — see ``opt_pspec``).
    """
    global _LAST_REPORT
    log = _FallbackLog()
    sizes = axis_sizes(mesh)
    expert_div = _moe_expert_div(cfg, sizes)

    def assign(name, leaf):
        ps = name.replace(".", "/")
        for pat, spec in _RULES:
            if re.search(pat, ps):
                spec = list(spec)
                if "expert" in spec:
                    if expert_div:
                        # EP on the expert dim; drop FSDP 'data' proposal on D
                        spec = ["model" if s == "expert" else
                                ("data" if s == "data" else None) for s in spec]
                    else:
                        # TP inside experts; expert dim replicated
                        spec = [None if s == "expert" else s for s in spec]
                if not training:
                    spec = [None if s == "data" else s for s in spec]
                if not tp:
                    spec = [None for _ in spec]
                return _sanitize(tuple(spec), tuple(leaf.shape), sizes, ps,
                                 log)
        return ()  # norms, biases, gates: replicated

    specs = {name: assign(name, leaf) for name, leaf in shapes.items()}
    _LAST_REPORT = log
    return specs


def batch_specs_pspec(cfg, shape, mesh, *, all_axes: bool = False) -> dict:
    """Specs for the input batch dict.  ``all_axes`` shards the batch over
    every mesh axis (pure data parallelism — for TP-hostile archs whose
    dims divide nothing, e.g. whisper train)."""
    from ..models.io import batch_specs as bs

    sizes = axis_sizes(mesh)
    dp = _dp_axes(sizes)
    if all_axes:
        dp = (("pod",) if "pod" in sizes else ()) + ("data", "model")
        n = 1
        for a in dp:
            n *= sizes[a]
    else:
        n = _dp_size(sizes)

    def assign(leaf):
        if leaf.shape and leaf.shape[0] % n == 0:
            return (dp, *([None] * (len(leaf.shape) - 1)))
        return ()

    return {k: assign(v) for k, v in bs(cfg, shape).items()}


def cache_pspec(cfg, shape, mesh, cache_tree: dict) -> dict:
    """Decode-cache specs: batch on data when divisible, else sequence
    (long-context, batch=1); heads on model when divisible."""
    sizes = axis_sizes(mesh)
    dp_size = _dp_size(sizes)
    dp = _dp_axes(sizes)
    model = sizes.get("model", 1)

    def assign(ps, leaf):
        shp = tuple(leaf.shape)
        if not shp:
            return ()
        if re.search(r"(^|/)(k|v|xk|xv)$", ps) and len(shp) == 5:
            # (L, B, S, Hkv, hd)
            spec = [None] * 5
            if shp[1] % dp_size == 0:
                spec[1] = dp
            elif shp[2] % dp_size == 0:
                spec[2] = dp          # sequence-parallel KV (batch==1)
            if shp[3] % model == 0:
                spec[3] = "model"
            elif spec[2] is None and shp[2] % model == 0:
                spec[2] = "model"     # few KV heads: shard the sequence
            return tuple(spec)
        if re.search(r"(^|/)(m|m_tail)$", ps) and len(shp) >= 4:
            # ssm states (..., B, H, dk, dv)
            spec = [None] * len(shp)
            b_dim = len(shp) - 4
            if shp[b_dim] % dp_size == 0:
                spec[b_dim] = dp
            if shp[b_dim + 1] % model == 0:
                spec[b_dim + 1] = "model"
            return tuple(spec)
        if re.search(r"conv", ps) and len(shp) >= 3:
            spec = [None] * len(shp)
            if shp[-3] % dp_size == 0:
                spec[-3] = dp
            if shp[-1] % model == 0:
                spec[-1] = "model"
            return tuple(spec)
        return ()  # pos scalar, small states

    return {k: assign(k, v) for k, v in cache_tree.items()}


def opt_pspec(param_pspecs: dict, *, shapes=None, mesh=None,
              zero1: bool = False) -> dict:
    """Optimizer moments share the parameter sharding; the step is
    replicated.

    ``zero1=True`` (pure-DP archs): moments are sharded over 'data' on the
    first divisible dim of each per-layer tensor even when the weights
    are replicated — the update is elementwise, so this costs one
    param-sized all-gather per step and saves (8 bytes/param) ×
    (1 − 1/|data|) of memory."""
    if zero1 and shapes is not None and mesh is not None:
        n = axis_sizes(mesh).get("data", 1)

        def assign(leaf):
            for dim, size in enumerate(leaf.shape):
                if size % n == 0 and size >= n:
                    out = [None] * len(leaf.shape)
                    out[dim] = "data"
                    return tuple(out)
            return ()

        moments = {k: assign(shapes[k]) for k in param_pspecs}
        return {"m": moments, "v": dict(moments), "step": ()}
    return {"m": dict(param_pspecs), "v": dict(param_pspecs), "step": ()}


def _dp_axes(sizes: dict):
    return ("pod", "data") if "pod" in sizes else "data"


def _dp_size(sizes: dict) -> int:
    n = sizes.get("data", 1)
    if "pod" in sizes:
        n *= sizes["pod"]
    return n


def placements(mesh, spec_tree):
    """DTensor placements of a spec (or of a dict tree of specs): one
    entry a mesh dim, ``Shard(d)`` where the spec names that mesh axis
    on tensor dim ``d``, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    if isinstance(spec_tree, dict):
        return {k: placements(mesh, v) for k, v in spec_tree.items()}
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec_tree):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                out[names.index(axis)] = Shard(dim)
    return tuple(out)
