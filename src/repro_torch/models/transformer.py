"""Model assembly for the dense family.

The port of ``src/repro/models/transformer.py`` for ``family == "dense"``
(llama/qwen/yi/command-r/stablelm).  The model is an ``nn.Module`` of
weights (:class:`DenseLM`); the functions take ``cfg`` first, as in the
reference, and a Python loop over the blocks takes the place of
``jax.lax.scan``.

Public API:
  init_params(cfg, generator, device=None)  -> model
  forward(cfg, model, batch, last_only=)    -> logits
  init_cache(cfg, batch, max_len, device=)  -> decode cache
  fill_cache(cfg, model, batch, cache)      -> cache
  prefill(cfg, model, batch, max_len)       -> (last_logits, cache)
  decode_step(cfg, model, cache, tokens)    -> (logits, cache)

``batch`` is ``{"tokens": (B, S) integer tensor}``.  The cache is
``{"k", "v": (L, B, max_len, Hkv, hd), "pos": int}`` and is updated in
place.  :func:`prefill` makes one pass over the layers that fills the
cache and unembeds the last position only, where the reference runs
``forward`` and ``fill_cache`` and leaves XLA to share their work.

The other families (moe, vlm, audio, ssm, hybrid) are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from .attention import (
    attention, attn_init, decode_attention, init_layer_cache,
)
from .layers import (
    Params, dense_init, embed_init, mlp_init, norm_apply, norm_init,
    swiglu_mlp,
)

__all__ = [
    "DenseBlock", "DenseLM", "init_params", "forward", "init_cache",
    "fill_cache", "prefill", "decode_step",
]

#: family -> the ROADMAP item that ports it
_NOT_PORTED = {
    "moe": "ROADMAP Queue 1 items 9-10 (models/moe.py)",
    "vlm": "ROADMAP Queue 1 item 10 (vlm)",
    "audio": "ROADMAP Queue 1 item 10 (audio enc-dec)",
    "ssm": "ROADMAP Queue 1 item 10 (ssm, models/ssm.py)",
    "hybrid": "ROADMAP Queue 1 item 10 (hybrid, models/ssm.py)",
}


def _dt(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _check_family(cfg) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: "
            f"{_NOT_PORTED[cfg.family]}")


class DenseBlock(nn.Module):
    """Pre-norm block: ln1 -> attention -> residual, ln2 -> SwiGLU MLP."""

    def __init__(self, ln1: Params, attn: Params, ln2: Params, mlp: Params):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.mlp = ln1, attn, ln2, mlp


class DenseLM(nn.Module):
    """Embedding, blocks, final norm and (unless tied) the LM head."""

    def __init__(self, embed: torch.Tensor, layers: list,
                 final_norm: Params, lm_head: Optional[torch.Tensor]):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        self.lm_head = (None if lm_head is None
                        else nn.Parameter(lm_head, requires_grad=False))

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_params(cfg, generator: torch.Generator,
                device=None) -> DenseLM:
    """Random weights drawn from ``generator`` on ``device`` (default
    ``cuda``), layer by layer, as the reference's ``init_params`` lays
    them out (norm weights f32, the rest in ``cfg.dtype``)."""
    _check_family(cfg)
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, weights on {dev}")
    dtype = _dt(cfg)
    with torch.device(dev):
        embed = embed_init(generator, (cfg.vocab_size, cfg.d_model), dtype)
        layers = [
            DenseBlock(norm_init(cfg.d_model, cfg.norm),
                       attn_init(generator, cfg, dtype),
                       norm_init(cfg.d_model, cfg.norm),
                       mlp_init(generator, cfg.d_model, cfg.d_ff, dtype))
            for _ in range(cfg.n_layers)
        ]
        final_norm = norm_init(cfg.d_model, cfg.norm)
        lm_head = None if cfg.tied_embeddings else dense_init(
            generator, (cfg.d_model, cfg.vocab_size), dtype=dtype)
    return DenseLM(embed, layers, final_norm, lm_head)


def _embed_inputs(cfg, model: DenseLM, batch: dict):
    tokens = batch["tokens"].to(model.device)
    x = model.embed[tokens].to(_dt(cfg))
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    return x, positions


def _dense_block(cfg, p: DenseBlock, x: torch.Tensor,
                 positions: torch.Tensor):
    """One block; returns (x, (k, v)) with the block's k/v heads."""
    h = norm_apply(p.ln1, x, cfg.norm)
    a, kv = attention(p.attn, cfg, h, positions)
    x = x + a
    h = norm_apply(p.ln2, x, cfg.norm)
    return x + swiglu_mlp(p.mlp, h), kv


def _unembed(cfg, model: DenseLM, x: torch.Tensor) -> torch.Tensor:
    x = norm_apply(model.final_norm, x, cfg.norm)
    head = model.embed.T if model.lm_head is None else model.lm_head
    return x @ head


@torch.no_grad()
def forward(cfg, model: DenseLM, batch: dict, *,
            last_only: bool = False) -> torch.Tensor:
    """Full-sequence logits.  ``last_only`` unembeds the final position
    only (serving prefill needs just the next-token distribution)."""
    _check_family(cfg)
    x, positions = _embed_inputs(cfg, model, batch)
    for p in model.layers:
        x, _ = _dense_block(cfg, p, x, positions)
    if last_only:
        x = x[:, -1:, :]
    return _unembed(cfg, model, x)


def init_cache(cfg, batch: int, max_len: int, device=None) -> dict:
    _check_family(cfg)
    return init_layer_cache(cfg, batch, max_len, _dt(cfg),
                            device=resolve_device(device))


def _prefill_pass(cfg, model: DenseLM, batch: dict, cache: dict,
                  logits: bool):
    """One pass over the layers: each writes its k/v into the cache; the
    last position is unembedded when ``logits``."""
    _check_family(cfg)
    x, positions = _embed_inputs(cfg, model, batch)
    s = x.shape[1]
    if s > cache["k"].shape[2]:
        raise ValueError(f"prompt of {s} tokens exceeds the cache's "
                         f"{cache['k'].shape[2]} positions")
    for i, p in enumerate(model.layers):
        x, (k, v) = _dense_block(cfg, p, x, positions)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
    cache["pos"] = s
    return (_unembed(cfg, model, x[:, -1:, :]) if logits else None), cache


@torch.no_grad()
def fill_cache(cfg, model: DenseLM, batch: dict, cache: dict) -> dict:
    """Populate the cache from a full prompt."""
    return _prefill_pass(cfg, model, batch, cache, logits=False)[1]


@torch.no_grad()
def prefill(cfg, model: DenseLM, batch: dict, max_len: int):
    """Run the full prompt, build the decode cache, return the last
    position's logits (B, 1, V) and the cache."""
    cache = init_cache(cfg, batch["tokens"].shape[0], max_len,
                       device=model.device)
    return _prefill_pass(cfg, model, batch, cache, logits=True)


@torch.no_grad()
def decode_step(cfg, model: DenseLM, cache: dict, tokens: torch.Tensor):
    """One decode step.  tokens: (B, 1) -> (logits (B, 1, V), cache)."""
    _check_family(cfg)
    pos = cache["pos"]
    x = model.embed[tokens.to(model.device)].to(_dt(cfg))
    for i, p in enumerate(model.layers):
        h = norm_apply(p.ln1, x, cfg.norm)
        a, _, _ = decode_attention(p.attn, cfg, h, cache["k"][i],
                                   cache["v"][i], pos)
        x = x + a
        h = norm_apply(p.ln2, x, cfg.norm)
        x = x + swiglu_mlp(p.mlp, h)
    cache["pos"] = pos + 1
    return _unembed(cfg, model, x), cache
