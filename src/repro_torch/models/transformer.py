"""Model assembly for every family.

The port of ``src/repro/models/transformer.py`` for ``family`` in
dense (llama/qwen/yi/command-r/stablelm), moe (grok, qwen3-moe), vlm
(llava: dense with a patch-embedding prefix), audio (whisper
encoder-decoder), ssm (xlstm: superblocks of mLSTM blocks and one sLSTM
block) and hybrid (zamba2: Mamba2 superblocks, each followed by one
shared attention+MLP block, then a tail of Mamba2 blocks).  The model is
an ``nn.Module`` of weights (:class:`DenseLM` for dense, moe and vlm;
:class:`EncDecLM` for audio; :class:`XLSTMLM` for ssm; :class:`ZambaLM`
for hybrid); the functions take ``cfg`` first, as in the reference, and a
Python loop over the blocks takes the place of ``jax.lax.scan``.
``forward`` and ``loss_fn`` are differentiable: where the reference wraps
a scanned block in ``jax.checkpoint`` (``cfg.remat == "full"``), the
block runs under ``torch.utils.checkpoint`` while autograd records, so
its activations are recomputed in the backward; the serving functions
(``fill_cache``, ``prefill``, ``decode_step``) run without autograd.

Public API:
  init_params(cfg, generator, device=None)  -> model
  param_shapes(cfg)                         -> {name: TensorSpec}
  forward(cfg, model, batch, last_only=)    -> logits
  loss_fn(cfg, model, batch)                -> (loss, metrics)
  init_cache(cfg, batch, max_len, device=)  -> decode cache
  fill_cache(cfg, model, batch, cache)      -> cache
  prefill(cfg, model, batch, max_len)       -> (last_logits, cache)
  decode_step(cfg, model, cache, tokens)    -> (logits, cache)

``batch`` is ``{"tokens": (B, S) integer tensor}``, plus ``"patches"``
(B, n_patches, D) for vlm and ``"frames"`` (B, encoder_seq, D) for audio
(the stub frontends' embeddings, as :func:`repro_torch.models.make_batch`
draws them).  The cache keeps the reference's keys and shapes and is
updated in place:

* dense, moe, vlm: ``{"k", "v": (L, B, max_len, Hkv, hd), "pos": int}``;
* audio adds ``"xk", "xv": (L, B, encoder_seq, Hkv, hd)``;
* ssm: ``{"m": (n_sb, m_per, B, H, dk, dv + 1), "s_c", "s_n", "s_h":
  (n_sb, B, H, dh), "pos"}``, f32;
* hybrid: ``{"m": (n_sb, per, B, H, N, dh)`` f32, ``"conv": (n_sb, per,
  B, 3, Di)``, ``"m_tail"``, ``"conv_tail"`` (the same with a leading
  tail axis), ``"k", "v": (n_sb, B, max_len, Hkv, hd), "pos"}``.

For dense, moe and vlm :func:`prefill` makes one pass over the layers
that fills the cache and unembeds the last position only, where the
reference runs ``forward`` and ``fill_cache`` and leaves XLA to share
their work.

Tensor parallelism.  A model of any family placed on a mesh
(``sharding.place.distribute_model``) whose weights the ``model`` axis
shards computes tensor-parallel (:mod:`repro_torch.sharding.tp`): the
embedding is a lookup in this rank's vocabulary block plus an all-reduce
over the axis, attention (whisper's encoder and cross attention too) and
the MLPs split their heads and d_ff, the MoE d_ff inside each expert (or
its experts, "ep"), the mLSTM, sLSTM and Mamba2 mixers their inner width
(:mod:`repro_torch.models.ssm`), and the head gives each rank its
vocabulary columns: ``loss_fn`` is a vocabulary-parallel cross entropy,
with no whole (B, S, V) logits, while ``forward`` gathers them whole for
its callers.  Under ``act_shard="seq_model"`` the residual stream
between blocks (the decoder's and, where its length divides the axis,
the encoder's) is each rank's 1/|model| of the sequence
(``_act_constraint``), the norms run on it, and it is gathered before
each column-parallel product and reduce-scattered after each
row-parallel one.  ``prefill`` then places its cache by
``rules.cache_pspec`` (``models.io.place_cache``): the KV caches by
heads or sequence, the SSM states by heads, the conv windows by
channels, the sLSTM carry replicated; ``decode_step`` reads that
placement.

Audio, ssm and hybrid follow the reference exactly, including its
``fill_cache``, which only sets ``pos``: after :func:`prefill` the
attention caches and the SSM and conv states are still zero, so decoding
starts from zeros (ROADMAP Queue 3 records it as a fault of the
reference).  Their :func:`prefill` unembeds the last position only; the
reference unembeds every position and keeps the last, the same values.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.obs import SPAN_DECODE_STEP, SPAN_NORM, SPAN_PREFILL, program_span
from ..device import resolve_device
from ..sharding import place, tp
from ..sharding.place import local
from .attention import (
    attention, attn_init, cross_decode_attention, decode_attention,
    init_layer_cache,
)
from .layers import (
    Params, dense_init, embed_init, gelu_mlp, mlp_init, norm_apply,
    norm_init, swiglu_mlp,
)
from . import ssm
from .moe import moe_apply, moe_init

__all__ = [
    "DecoderBlock", "DenseBlock", "DenseLM", "EncDecLM", "EncoderBlock",
    "TensorSpec", "XLSTMLM", "ZambaLM", "init_params", "param_shapes",
    "forward", "loss_fn",
    "init_cache", "fill_cache", "prefill", "decode_step",
]


#: families whose ``fill_cache`` sets only ``pos``, as the reference's
_POS_ONLY_FILL = ("audio", "ssm", "hybrid")


def _dt(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def xlstm_layout(cfg) -> tuple:
    """(superblocks, mLSTM blocks a superblock): each superblock ends in
    one sLSTM block."""
    return cfg.n_layers // cfg.slstm_every, cfg.slstm_every - 1


def zamba_layout(cfg) -> tuple:
    """(superblocks, Mamba2 blocks a superblock, tail blocks): the shared
    attention block follows each superblock."""
    n_sb = cfg.n_layers // cfg.attn_every
    return n_sb, cfg.attn_every, cfg.n_layers - n_sb * cfg.attn_every


class DenseBlock(nn.Module):
    """Pre-norm block: ln1 -> attention -> residual, ln2 -> SwiGLU MLP
    (``mlp``) or mixture of experts (``moe``) -> residual."""

    def __init__(self, ln1: Params, attn: Params, ln2: Params,
                 mlp: Optional[Params] = None, moe: Optional[Params] = None):
        super().__init__()
        if (mlp is None) == (moe is None):
            raise ValueError("a block has an mlp or a moe, not both")
        self.ln1, self.attn, self.ln2 = ln1, attn, ln2
        self.mlp, self.moe = mlp, moe


class EncoderBlock(nn.Module):
    """Whisper encoder block: ln1 -> attention, ln2 -> GELU MLP."""

    def __init__(self, ln1: Params, attn: Params, ln2: Params, mlp: Params):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.mlp = ln1, attn, ln2, mlp


class DecoderBlock(nn.Module):
    """Whisper decoder block: ln1 -> causal self-attention, lnx ->
    cross-attention on the encoder's output, ln2 -> GELU MLP."""

    def __init__(self, ln1: Params, attn: Params, lnx: Params,
                 xattn: Params, ln2: Params, mlp: Params):
        super().__init__()
        self.ln1, self.attn, self.lnx, self.xattn = ln1, attn, lnx, xattn
        self.ln2, self.mlp = ln2, mlp


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


class EncDecLM(nn.Module):
    """Whisper: embedding (tied to the unembedding), encoder blocks and
    their norm, decoder blocks, final norm."""

    def __init__(self, embed: torch.Tensor, encoder: list, enc_norm: Params,
                 decoder: list, final_norm: Params):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.encoder = nn.ModuleList(encoder)
        self.enc_norm = enc_norm
        self.decoder = nn.ModuleList(decoder)
        self.final_norm = final_norm

    @property
    def device(self) -> torch.device:
        return self.embed.device


class XLSTMLM(nn.Module):
    """xLSTM: embedding, superblocks of mLSTM blocks (``mblocks[sb][i]``)
    each followed by one sLSTM block (``sblocks[sb]``), final norm and
    the LM head."""

    def __init__(self, embed: torch.Tensor, mblocks: list, sblocks: list,
                 final_norm: Params, lm_head: torch.Tensor):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.mblocks = nn.ModuleList(nn.ModuleList(sb) for sb in mblocks)
        self.sblocks = nn.ModuleList(sblocks)
        self.final_norm = final_norm
        self.lm_head = nn.Parameter(lm_head, requires_grad=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device


class ZambaLM(nn.Module):
    """Zamba2: embedding, superblocks of Mamba2 blocks (``mamba_sb[sb][i]``)
    each followed by the ONE shared attention+MLP block
    (``shared_attn``, a :class:`DenseBlock` whose weights every use
    shares), a tail of Mamba2 blocks (``mamba_tail``), final norm and the
    LM head."""

    def __init__(self, embed: torch.Tensor, mamba_sb: list,
                 mamba_tail: list, shared_attn: DenseBlock,
                 final_norm: Params, lm_head: torch.Tensor):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.mamba_sb = nn.ModuleList(nn.ModuleList(sb) for sb in mamba_sb)
        self.mamba_tail = nn.ModuleList(mamba_tail)
        self.shared_attn = shared_attn
        self.final_norm = final_norm
        self.lm_head = nn.Parameter(lm_head, requires_grad=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def _encdec_init(cfg, generator: torch.Generator, dtype) -> EncDecLM:
    d, f = cfg.d_model, cfg.d_ff
    embed = embed_init(generator, (cfg.vocab_size, d), dtype)
    encoder = [EncoderBlock(norm_init(d, cfg.norm),
                            attn_init(generator, cfg, dtype),
                            norm_init(d, cfg.norm),
                            mlp_init(generator, d, f, dtype, kind="gelu"))
               for _ in range(cfg.encoder_layers)]
    decoder = [DecoderBlock(norm_init(d, cfg.norm),
                            attn_init(generator, cfg, dtype),
                            norm_init(d, cfg.norm),
                            attn_init(generator, cfg, dtype),
                            norm_init(d, cfg.norm),
                            mlp_init(generator, d, f, dtype, kind="gelu"))
               for _ in range(cfg.n_layers)]
    return EncDecLM(embed, encoder, norm_init(d, cfg.norm), decoder,
                    norm_init(d, cfg.norm))


def _xlstm_init(cfg, generator: torch.Generator, dtype) -> XLSTMLM:
    n_sb, m_per = xlstm_layout(cfg)
    embed = embed_init(generator, (cfg.vocab_size, cfg.d_model), dtype)
    mblocks = [[ssm.mlstm_init(generator, cfg, dtype) for _ in range(m_per)]
               for _ in range(n_sb)]
    sblocks = [ssm.slstm_init(generator, cfg, dtype) for _ in range(n_sb)]
    return XLSTMLM(embed, mblocks, sblocks, norm_init(cfg.d_model, cfg.norm),
                   dense_init(generator, (cfg.d_model, cfg.vocab_size),
                              dtype=dtype))


def _zamba_init(cfg, generator: torch.Generator, dtype) -> ZambaLM:
    n_sb, per, tail = zamba_layout(cfg)
    d = cfg.d_model
    embed = embed_init(generator, (cfg.vocab_size, d), dtype)
    mamba_sb = [[ssm.mamba2_init(generator, cfg, dtype) for _ in range(per)]
                for _ in range(n_sb)]
    mamba_tail = [ssm.mamba2_init(generator, cfg, dtype)
                  for _ in range(tail)]
    shared = DenseBlock(norm_init(d, cfg.norm),
                        attn_init(generator, cfg, dtype),
                        norm_init(d, cfg.norm),
                        mlp=mlp_init(generator, d, cfg.d_ff, dtype))
    return ZambaLM(embed, mamba_sb, mamba_tail, shared,
                   norm_init(d, cfg.norm),
                   dense_init(generator, (d, cfg.vocab_size), dtype=dtype))


def init_params(cfg, generator: torch.Generator, device=None):
    """Random weights drawn from ``generator`` on ``device`` (default
    ``cuda``), layer by layer, as the reference's ``init_params`` lays
    them out (norm weights, the router and the SSM gates f32, the rest in
    ``cfg.dtype``)."""
    dev = resolve_device(device)
    if dev.type != "meta" and generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, weights on {dev}")
    dtype = _dt(cfg)
    with torch.device(dev):
        if cfg.family == "audio":
            return _encdec_init(cfg, generator, dtype)
        if cfg.family == "ssm":
            return _xlstm_init(cfg, generator, dtype)
        if cfg.family == "hybrid":
            return _zamba_init(cfg, generator, dtype)
        embed = embed_init(generator, (cfg.vocab_size, cfg.d_model), dtype)
        layers = []
        for _ in range(cfg.n_layers):
            ln1 = norm_init(cfg.d_model, cfg.norm)
            attn = attn_init(generator, cfg, dtype)
            ln2 = norm_init(cfg.d_model, cfg.norm)
            ffn = ({"moe": moe_init(generator, cfg, dtype)} if cfg.is_moe
                   else {"mlp": mlp_init(generator, cfg.d_model, cfg.d_ff,
                                         dtype)})
            layers.append(DenseBlock(ln1, attn, ln2, **ffn))
        final_norm = norm_init(cfg.d_model, cfg.norm)
        lm_head = None if cfg.tied_embeddings else dense_init(
            generator, (cfg.d_model, cfg.vocab_size), dtype=dtype)
    return DenseLM(embed, layers, final_norm, lm_head)


class TensorSpec(NamedTuple):
    """A tensor's shape and dtype, with no storage (the reference's
    ``jax.ShapeDtypeStruct``)."""

    shape: tuple
    dtype: torch.dtype

    @property
    def size(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        return self.size * self.dtype.itemsize


def param_shapes(cfg) -> dict:
    """``{name: TensorSpec}`` of the model's parameters, in
    ``named_parameters`` order: the model built on the ``meta`` device,
    so a full-size config allocates nothing (the reference's
    ``jax.eval_shape`` of ``init_params``)."""
    model = init_params(cfg, torch.Generator(), device="meta")
    return {name: TensorSpec(tuple(t.shape), t.dtype)
            for name, t in model.named_parameters()}


def _tp_axis(cfg, model) -> Optional[tp.TP]:
    """The ``model`` axis the model computes tensor-parallel over, or
    None (module docstring)."""
    return tp.axis_of(cfg, model.parameters())


def _seq_parallel(cfg, t: Optional[tp.TP], s: int) -> bool:
    """The residual stream is each rank's block of the ``s`` positions:
    ``act_shard="seq_model"`` on a tensor-parallel model, where ``s``
    divides the axis (the reference's ``_act_constraint`` rule)."""
    return (t is not None and cfg.act_shard == "seq_model" and s > 1
            and s % t.n == 0)


def _embed_tokens(cfg, model, tokens: torch.Tensor, t: Optional[tp.TP],
                  scatter: bool = False) -> torch.Tensor:
    """The tokens' embeddings; with a vocabulary-sharded table, a lookup
    in this rank's block (zero elsewhere) summed over the axis, or
    reduce-scattered along the sequence where ``scatter``."""
    if not tp.sharded(t, model.embed, 0):
        x = local(model.embed)[tokens].to(_dt(cfg))
        return tp.split(x, 1, t) if scatter else x
    table = local(model.embed, keep_model=True)
    index = tokens.long() - t.i * table.shape[0]
    held = (index >= 0) & (index < table.shape[0])
    x = (table[index.clamp(0, table.shape[0] - 1)]
         * held[..., None]).to(_dt(cfg))
    return tp.reduce_scatter(x, 1, t) if scatter else tp.reduce_from(x, t)


def _embed_inputs(cfg, model: DenseLM, batch: dict,
                  t: Optional[tp.TP] = None, seq: bool = False):
    """Token embedding, after the patch prefix for vlm; positions over
    the whole length.  Under ``seq`` the embedding is this rank's block
    of the sequence."""
    tokens = batch["tokens"].to(model.device)
    vlm = cfg.family == "vlm"
    x = _embed_tokens(cfg, model, tokens, t, scatter=seq and not vlm)
    if vlm:
        patches = batch["patches"].to(model.device, _dt(cfg))
        x = _act_constraint(cfg, torch.cat([patches, x], dim=1), t)
    b, s = tokens.shape[0], tokens.shape[1] + (cfg.n_patches if vlm else 0)
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    return x, positions


def _norm(cfg, p: Params, x: torch.Tensor, seq: bool) -> torch.Tensor:
    """``norm_apply``; under ``seq`` each rank normalises other positions,
    so the weights' gradient is a partial sum over the ``model`` axis
    too."""
    if not seq:
        return norm_apply(p, x, cfg.norm)
    axes = place.current_batch_axes() + ("model",)
    return norm_apply({name: local(w, axes)
                       for name, w in p._parameters.items()}, x, cfg.norm)


def _ffn(cfg, p: DenseBlock, h: torch.Tensor, t: Optional[tp.TP] = None,
         seq: bool = False) -> torch.Tensor:
    if cfg.is_moe:
        return moe_apply(p.moe, cfg, h, t=t, seq=seq)
    return swiglu_mlp(p.mlp, h, t, seq)


def _remat(cfg, block: nn.Module, fn: Callable, x: torch.Tensor
           ) -> torch.Tensor:
    """``fn(x)``, its activations recomputed in the backward
    (``torch.utils.checkpoint``) where the reference's ``_maybe_remat``
    applies ``jax.checkpoint``: ``cfg.remat == "full"`` and autograd
    records through ``x`` or ``block``'s weights."""
    if cfg.remat == "full" and torch.is_grad_enabled() and (
            x.requires_grad or any(w.requires_grad
                                   for w in block.parameters())):
        return checkpoint(fn, x, use_reentrant=False)
    return fn(x)


def _dense_block(cfg, p: DenseBlock, x: torch.Tensor,
                 positions: torch.Tensor, t: Optional[tp.TP] = None,
                 seq: bool = False):
    """One block; returns (x, (k, v)) with the block's k/v heads.  With
    ``t``, tensor-parallel (``x`` this rank's block of the sequence under
    ``seq``)."""
    with program_span(SPAN_NORM):
        h = _norm(cfg, p.ln1, x, seq)
    a, kv = attention(p.attn, cfg, h, positions, t=t, seq=seq)
    x = x + a
    with program_span(SPAN_NORM):
        h = _norm(cfg, p.ln2, x, seq)
    return x + _ffn(cfg, p, h, t, seq), kv


def _head_weight(model) -> tuple:
    """(the unembedding weight as stored, its vocabulary dim); whisper's
    is its embedding."""
    head = getattr(model, "lm_head", None)
    return (model.embed, 0) if head is None else (head, 1)


def _head(model, t: Optional[tp.TP]):
    """(the unembedding (D, V), or this rank's vocabulary columns of it,
    and the first vocabulary id it holds); the id is None where the head
    is whole."""
    w, dim = _head_weight(model)
    if tp.sharded(t, w, dim):
        head = local(w, keep_model=True)
        head = head.T if dim == 0 else head
        return head, t.i * head.shape[1]
    head = local(w)
    return (head.T if dim == 0 else head), None


def _unembed(cfg, model: DenseLM, x: torch.Tensor,
             t: Optional[tp.TP] = None) -> torch.Tensor:
    """Whole logits of ``x`` (every position of it on every rank); a
    vocabulary-sharded head's columns are gathered over the axis."""
    x = norm_apply(model.final_norm, x, cfg.norm)
    head, v0 = _head(model, t)
    if v0 is None:
        return x @ head
    return tp.gather(tp.copy_to(x, t) @ head, -1, t)


# -- audio (whisper) ---------------------------------------------------------


def _sinusoidal(s: int, d: int, device) -> torch.Tensor:
    pos = torch.arange(s, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10_000.0, dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _sinusoidal_at(pos: int, d: int, device) -> torch.Tensor:
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)
    ang = pos / torch.pow(10_000.0, dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)])[None, None, :]


def _whisper_encode(cfg, model: EncDecLM, frames: torch.Tensor,
                    t: Optional[tp.TP] = None) -> tuple:
    """frames: (B, enc_seq, D) precomputed embeddings (conv-frontend
    stub).  Non-causal self-attention, no RoPE.  Returns (the encoder's
    output, whether it is this rank's block of the frames: sequence
    parallelism where their number divides the axis)."""
    dt = _dt(cfg)
    frames = frames.to(model.device)
    x = frames.to(dt) + _sinusoidal(frames.shape[1], cfg.d_model,
                                    model.device).to(dt)
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device).expand(x.shape[:2])
    seq = _seq_parallel(cfg, t, x.shape[1])
    if seq:
        x = tp.split(x, 1, t)

    def block(p, x):
        h = _norm(cfg, p.ln1, x, seq)
        a, _ = attention(p.attn, cfg, h, positions, causal=False,
                         use_rope=False, t=t, seq=seq)
        x = x + a
        h = _norm(cfg, p.ln2, x, seq)
        return x + gelu_mlp(p.mlp, h, t, seq)

    for p in model.encoder:
        x = _remat(cfg, p, functools.partial(block, p), x)
    return _norm(cfg, model.enc_norm, x, seq), seq


def _whisper_decode_full(cfg, model: EncDecLM, tokens: torch.Tensor,
                         enc: tuple, t: Optional[tp.TP] = None,
                         seq: bool = False) -> torch.Tensor:
    """Causal self-attention, then non-causal cross-attention on the
    encoder's output (``enc``, as :func:`_whisper_encode` returns it),
    then the GELU MLP, in each decoder block; under ``seq`` the stream is
    this rank's block of the tokens."""
    enc_out, enc_seq = enc
    dt = _dt(cfg)
    tokens = tokens.to(model.device)
    b, s = tokens.shape
    pos = _sinusoidal(s, cfg.d_model, model.device).to(dt)
    x = _embed_tokens(cfg, model, tokens, t, scatter=seq) + (
        pos.chunk(t.n, dim=0)[t.i] if seq else pos)
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)

    def block(p, x):
        h = _norm(cfg, p.ln1, x, seq)
        a, _ = attention(p.attn, cfg, h, positions, use_rope=False, t=t,
                         seq=seq)
        x = x + a
        h = _norm(cfg, p.lnx, x, seq)
        a, _ = attention(p.xattn, cfg, h, positions, causal=False,
                         kv_x=enc_out, use_rope=False, t=t, seq=seq,
                         kv_seq=enc_seq)
        x = x + a
        h = _norm(cfg, p.ln2, x, seq)
        return x + gelu_mlp(p.mlp, h, t, seq)

    for p in model.decoder:
        x = _remat(cfg, p, functools.partial(block, p), x)
    return x


# -- the public functions -----------------------------------------------------


def forward(cfg, model, batch: dict, *,
            last_only: bool = False) -> torch.Tensor:
    """Full-sequence logits (training / prefill).  ``last_only`` unembeds
    the final position only (serving prefill needs just the next-token
    distribution)."""
    t = _tp_axis(cfg, model)
    x, seq = _hidden(cfg, model, batch, t)
    if seq:
        x = tp.gather(x[:, -1:] if last_only else x, 1, t)
    if last_only:
        x = x[:, -1:, :]
    return _unembed(cfg, model, x, t)


def _hidden(cfg, model, batch: dict, t: Optional[tp.TP]) -> tuple:
    """(the last block's output, whether it is this rank's block of the
    sequence): whisper's decoder over its encoder, the other families'
    backbone over their embedded inputs."""
    seq = _seq_parallel(cfg, t, _seq_len(cfg, batch))
    if cfg.family == "audio":
        enc = _whisper_encode(cfg, model, batch["frames"], t)
        return _whisper_decode_full(cfg, model, batch["tokens"], enc, t,
                                    seq), seq
    x, positions = _embed_inputs(cfg, model, batch, t, seq)
    return _backbone_full(cfg, model, x, positions, t, seq), seq


def _seq_len(cfg, batch: dict) -> int:
    """The length of the residual stream: the tokens, after the patch
    prefix for vlm."""
    return batch["tokens"].shape[1] + (cfg.n_patches if cfg.family == "vlm"
                                       else 0)


def _act_constraint(cfg, x, t: Optional[tp.TP] = None):
    """Sequence-parallel residual stream (``act_shard="seq_model"``),
    where the token dim divides the ``model`` axis, as the reference's
    ``with_sharding_constraint``: a DTensor residual is redistributed to
    ``Shard(1)`` on the axis; a plain whole-sequence residual of a
    tensor-parallel model (``t``) becomes this rank's block of it.  The
    identity on any other plain tensor: the sharded step keeps the
    residual as each rank's local rows
    (:mod:`repro_torch.sharding.place`), and a tensor-parallel stream
    that is already a block stays one."""
    if cfg.act_shard != "seq_model" or x.ndim != 3 or x.shape[1] <= 1:
        return x
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(x, DTensor):
        return tp.split(x, 1, t) if _seq_parallel(cfg, t, x.shape[1]) else x
    mesh = x.device_mesh
    names = mesh.mesh_dim_names or ()
    if "model" not in names or x.shape[1] % mesh.size(
            names.index("model")):
        return x
    placements = list(x.placements)
    placements[names.index("model")] = Shard(1)
    return x.redistribute(mesh, placements)


def _backbone_full(cfg, model, x: torch.Tensor,
                   positions: torch.Tensor, t: Optional[tp.TP] = None,
                   seq: bool = False) -> torch.Tensor:
    """Full-sequence pass through the blocks (train / prefill).  The
    blocks the reference recomputes under ``cfg.remat == "full"``: each
    dense block, the mLSTM blocks (not the sLSTM ones) and the Mamba2
    blocks (not the shared attention block).  With ``t`` the blocks run
    tensor-parallel (``x`` this rank's block of the sequence under
    ``seq``, and so is the result)."""
    if cfg.family == "ssm":
        for mblocks, sblock in zip(model.mblocks, model.sblocks):
            for p in mblocks:
                x = _remat(cfg, p, functools.partial(
                    ssm.mlstm_apply, p, cfg, t=t, seq=seq), x)
            x = ssm.slstm_apply(sblock, cfg, x, t=t, seq=seq)
        return x
    if cfg.family == "hybrid":
        def mamba(p, x):
            return _remat(cfg, p, functools.partial(
                ssm.mamba2_apply, p, cfg, t=t, seq=seq), x)

        for mblocks in model.mamba_sb:
            for p in mblocks:
                x = mamba(p, x)
            x, _ = _dense_block(cfg, model.shared_attn, x, positions, t, seq)
        for p in model.mamba_tail:
            x = mamba(p, x)
        return x

    def block(p, x):
        return _dense_block(cfg, p, x, positions, t, seq)[0]

    for p in model.layers:
        x = _act_constraint(cfg, x)
        x = _remat(cfg, p, functools.partial(block, p), x)
    return _act_constraint(cfg, x)


def loss_fn(cfg, model, batch: dict):
    """Next-token cross entropy, the mean over every (row, position) but
    the last; for vlm only the text positions count.  Returns (loss,
    {"loss", "perplexity"}), f32 scalars; differentiable with respect to
    the weights where they require grad.  A tensor-parallel model with a
    vocabulary-sharded head takes the vocabulary-parallel cross entropy
    (``tp.vocab_parallel_nll``): no rank builds whole logits."""
    t = _tp_axis(cfg, model)
    if t is not None and tp.sharded(t, *_head_weight(model)):
        return _tp_loss(cfg, model, batch, t)
    logits = forward(cfg, model, batch).float()
    tokens = batch["tokens"].to(model.device)
    if cfg.family == "vlm":
        logits = logits[:, cfg.n_patches:, :]            # text segment
    shift_logits = logits[:, :-1]
    shift_labels = tokens[:, 1:].long()
    logz = torch.logsumexp(shift_logits, dim=-1)
    gold = torch.gather(shift_logits, -1, shift_labels[..., None])[..., 0]
    nll = (logz - gold).mean()
    return nll, {"loss": nll, "perplexity": torch.exp(nll)}


def _tp_loss(cfg, model, batch: dict, t: tp.TP):
    """``loss_fn`` of a tensor-parallel model whose head is split over the
    vocabulary: the final norm on this rank's positions (under seq), the
    sequence gathered, each rank's logit columns, then
    ``tp.vocab_parallel_nll``.  The same on every rank of the axis."""
    x, seq = _hidden(cfg, model, batch, t)
    x = _norm(cfg, model.final_norm, x, seq)
    x = tp.gather_sum(x, 1, t) if seq else tp.copy_to(x, t)
    if cfg.family == "vlm":
        x = x[:, cfg.n_patches:]                          # text segment
    head, v0 = _head(model, t)
    tokens = batch["tokens"].to(model.device)
    nll = tp.vocab_parallel_nll(x[:, :-1] @ head, tokens[:, 1:], v0,
                                t).mean()
    return nll, {"loss": nll, "perplexity": torch.exp(nll)}


def init_cache(cfg, batch: int, max_len: int, device=None) -> dict:
    dev = resolve_device(device)
    f32 = torch.float32
    if cfg.family == "ssm":
        n_sb, m_per = xlstm_layout(cfg)
        ms = ssm.mlstm_state_shape(cfg, batch)
        ss = ssm.slstm_state_shape(cfg, batch)
        return {
            "m": torch.zeros((n_sb, m_per, *ms), dtype=f32, device=dev),
            **{name: torch.zeros((n_sb, *ss), dtype=f32, device=dev)
               for name in ("s_c", "s_n", "s_h")},
            "pos": 0,
        }
    if cfg.family == "hybrid":
        n_sb, per, tail = zamba_layout(cfg)
        st, cv = ssm.mamba2_state_shapes(cfg, batch)
        kv = (n_sb, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        return {
            "m": torch.zeros((n_sb, per, *st), dtype=f32, device=dev),
            "conv": torch.zeros((n_sb, per, *cv), dtype=_dt(cfg), device=dev),
            "m_tail": torch.zeros((tail, *st), dtype=f32, device=dev),
            "conv_tail": torch.zeros((tail, *cv), dtype=_dt(cfg), device=dev),
            "k": torch.zeros(kv, dtype=_dt(cfg), device=dev),
            "v": torch.zeros(kv, dtype=_dt(cfg), device=dev),
            "pos": 0,
        }
    cache = init_layer_cache(cfg, batch, max_len, _dt(cfg), device=dev)
    if cfg.family == "audio":
        shape = (cfg.n_layers, batch, cfg.encoder_seq, cfg.n_kv_heads,
                 cfg.head_dim)
        cache["xk"] = torch.zeros(shape, dtype=_dt(cfg), device=dev)
        cache["xv"] = torch.zeros(shape, dtype=_dt(cfg), device=dev)
    return cache


def _cache_blocks(cache: dict, names: tuple = ("k", "v")):
    """(this rank's blocks of the k and v caches (or of the ``names``
    pair), and the dim of a layer's (B, S, Hkv, hd) block the ``model``
    axis splits: 2 for the heads, 1 for the sequence, None where each
    rank holds it whole)."""
    k, v = (cache[n] for n in names)
    dim = tp.model_dim(k)
    if not place.is_dtensor(k):
        return k, v, None
    return k.to_local(), v.to_local(), None if dim is None else dim - 1


def _local_states(cache: dict, names: tuple) -> dict:
    """This rank's blocks of the cache's ``names`` states (views, written
    in place)."""
    return {n: cache[n].to_local() if place.is_dtensor(cache[n])
            else cache[n] for n in names}


def _prefill_pass(cfg, model: DenseLM, batch: dict, cache: dict,
                  logits: bool):
    """One pass over the layers: each writes its k/v into the cache (this
    rank's block of a placed one); the last position is unembedded when
    ``logits``."""
    t = _tp_axis(cfg, model)
    seq = _seq_parallel(cfg, t, _seq_len(cfg, batch))
    x, positions = _embed_inputs(cfg, model, batch, t, seq)
    s = positions.shape[1]
    if s > cache["k"].shape[2]:
        raise ValueError(f"prompt of {s} positions exceeds the cache's "
                         f"{cache['k'].shape[2]} positions")
    kc, vc, dim = _cache_blocks(cache)
    # the cache block's first position, and how many of the prompt's it
    # holds
    lo = t.i * kc.shape[2] if dim == 1 else 0
    n = min(max(s - lo, 0), kc.shape[2])
    for i, p in enumerate(model.layers):
        x, (k, v) = _dense_block(cfg, p, x, positions, t, seq)
        kc[i, :, :n] = k[:, lo:lo + n]
        vc[i, :, :n] = v[:, lo:lo + n]
    cache["pos"] = s
    if not logits:
        return None, cache
    x = tp.gather(x[:, -1:], 1, t)[:, -1:] if seq else x[:, -1:]
    return _unembed(cfg, model, x, t), cache


@torch.no_grad()
def fill_cache(cfg, model, batch: dict, cache: dict) -> dict:
    """Populate the cache from a full prompt.  For audio, ssm and hybrid,
    as in the reference, only ``pos`` is set (to the prompt's length)."""
    if cfg.family in _POS_ONLY_FILL:
        cache["pos"] = batch["tokens"].shape[1]
        return cache
    return _prefill_pass(cfg, model, batch, cache, logits=False)[1]


@torch.no_grad()
def prefill(cfg, model, batch: dict, max_len: int):
    """Run the full prompt, build the decode cache, return the last
    position's logits (B, 1, V) and the cache."""
    with program_span(SPAN_PREFILL):
        return _prefill(cfg, model, batch, max_len)


def _prefill(cfg, model, batch: dict, max_len: int):
    t = _tp_axis(cfg, model)
    cache = init_cache(cfg, batch["tokens"].shape[0], max_len,
                       device="meta" if t else model.device)
    if t is not None:
        from .io import place_cache

        cache = place_cache(cfg, cache, model.embed.device_mesh,
                            device=model.device)
    if cfg.family in _POS_ONLY_FILL:
        logits = forward(cfg, model, batch, last_only=True)
        return logits, fill_cache(cfg, model, batch, cache)
    return _prefill_pass(cfg, model, batch, cache, logits=True)


@torch.no_grad()
def decode_step(cfg, model, cache: dict, tokens: torch.Tensor):
    """One decode step.  tokens: (B, 1) -> (logits (B, 1, V), cache)."""
    with program_span(SPAN_DECODE_STEP):
        return _decode_step(cfg, model, cache, tokens)


def _decode_step(cfg, model, cache: dict, tokens: torch.Tensor):
    pos = cache["pos"]
    dt = _dt(cfg)
    t = _tp_axis(cfg, model)
    x = _embed_tokens(cfg, model, tokens.to(model.device), t)
    if cfg.family == "ssm":
        x = _xlstm_decode(cfg, model, cache, x, t)
        cache["pos"] = pos + 1
        return _unembed(cfg, model, x, t), cache
    if cfg.family == "hybrid":
        x = _zamba_decode(cfg, model, cache, x, pos, t)
        cache["pos"] = pos + 1
        return _unembed(cfg, model, x, t), cache
    kc, vc, dim = _cache_blocks(cache)
    if cfg.family == "audio":
        xk, xv, xdim = _cache_blocks(cache, ("xk", "xv"))
        x = x + _sinusoidal_at(pos, cfg.d_model, x.device).to(dt)
        for i, p in enumerate(model.decoder):
            h = norm_apply(p.ln1, x, cfg.norm)
            a, _, _ = decode_attention(p.attn, cfg, h, kc[i], vc[i], pos,
                                       use_rope=False, t=t, cache_dim=dim)
            x = x + a
            h = norm_apply(p.lnx, x, cfg.norm)
            x = x + cross_decode_attention(p.xattn, cfg, h, xk[i], xv[i],
                                           t=t, cache_dim=xdim)
            h = norm_apply(p.ln2, x, cfg.norm)
            x = x + gelu_mlp(p.mlp, h, t)
        cache["pos"] = pos + 1
        return _unembed(cfg, model, x, t), cache
    for i, p in enumerate(model.layers):
        with program_span(SPAN_NORM):
            h = norm_apply(p.ln1, x, cfg.norm)
        a, _, _ = decode_attention(p.attn, cfg, h, kc[i], vc[i], pos, t=t,
                                   cache_dim=dim)
        x = x + a
        with program_span(SPAN_NORM):
            h = norm_apply(p.ln2, x, cfg.norm)
        x = x + _ffn(cfg, p, h, t)
    cache["pos"] = pos + 1
    return _unembed(cfg, model, x, t), cache


def _xlstm_decode(cfg, model: XLSTMLM, cache: dict, x: torch.Tensor,
                  t: Optional[tp.TP] = None) -> torch.Tensor:
    """One token through every block, each state (this rank's block of
    it) updated in place."""
    st = _local_states(cache, ("m", "s_c", "s_n", "s_h"))
    for sb, (mblocks, sblock) in enumerate(zip(model.mblocks, model.sblocks)):
        for i, p in enumerate(mblocks):
            x, new = ssm.mlstm_decode(p, cfg, x, st["m"][sb, i], t=t)
            st["m"][sb, i] = new
        carry = tuple(st[name][sb] for name in ("s_c", "s_n", "s_h"))
        x, carry = ssm.slstm_decode(sblock, cfg, x, carry, t=t)
        for name, new in zip(("s_c", "s_n", "s_h"), carry):
            st[name][sb] = new
    return x


def _zamba_decode(cfg, model: ZambaLM, cache: dict, x: torch.Tensor,
                  pos: int, t: Optional[tp.TP] = None) -> torch.Tensor:
    """One token through every block: the Mamba2 states and conv windows
    (this rank's blocks of them) updated in place, the shared block's
    attention against superblock ``sb``'s KV cache, written in place at
    ``pos``."""
    shared = model.shared_attn
    st = _local_states(cache, ("m", "conv", "m_tail", "conv_tail"))
    kc, vc, dim = _cache_blocks(cache)

    def mamba(p, x, state, conv):
        y, new, cv = ssm.mamba2_decode(p, cfg, x, state, conv, t=t)
        state.copy_(new)
        conv.copy_(cv)
        return y

    for sb, mblocks in enumerate(model.mamba_sb):
        for i, p in enumerate(mblocks):
            x = mamba(p, x, st["m"][sb, i], st["conv"][sb, i])
        h = norm_apply(shared.ln1, x, cfg.norm)
        a, _, _ = decode_attention(shared.attn, cfg, h, kc[sb], vc[sb], pos,
                                   t=t, cache_dim=dim)
        x = x + a
        h = norm_apply(shared.ln2, x, cfg.norm)
        x = x + swiglu_mlp(shared.mlp, h, t)
    for i, p in enumerate(model.mamba_tail):
        x = mamba(p, x, st["m_tail"][i], st["conv_tail"][i])
    return x
