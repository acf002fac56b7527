"""Model + shape configuration system.

Copied from ``src/repro/configs/base.py``; only this docstring differs.

One :class:`ModelConfig` per assigned architecture (see the sibling modules)
plus the shape grid every architecture is exercised against.  ``reduced()``
derives the tiny same-family config used by the CPU smoke tests.

``attention_impl`` keeps the reference's values, so one config means the
same model in both packages: ``"reference"`` is the plain attention,
``"blocked"`` the online-softmax loop with its own backward
(:mod:`repro_torch.models.blocked_attention`), and ``"pallas"`` (the
reference's Pallas TPU kernel) routes prefill attention to the port's
hand-written Hopper flash-attention kernel
(:mod:`repro_torch.kernels.flash_attention`), which has no backward.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "reduced"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    rope_theta: float = 10_000.0
    tied_embeddings: bool = False
    dtype: str = "bfloat16"
    attention_impl: str = "reference"   # reference | pallas

    # -- MoE ---------------------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25

    # -- SSM / hybrid --------------------------------------------------------
    ssm_state: int = 0           # mamba2 state size N
    ssm_chunk: int = 256         # chunked linear-scan block length
    attn_every: int = 0          # hybrid: shared attn block every k blocks
    slstm_every: int = 0         # xlstm: one sLSTM block per k blocks

    # -- encoder/decoder -----------------------------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 0         # whisper: 1500 frames (30 s)

    # -- modality frontend stub ----------------------------------------------
    frontend: str = "none"       # none | audio | vlm
    n_patches: int = 0           # vlm: image patch embeddings per sample

    # -- training knobs --------------------------------------------------------
    remat: str = "full"          # full | none
    scan_layers: bool = True
    # activation sharding policy: "none" keeps batch-only sharding;
    # "seq_model" constrains the residual stream's sequence dim onto the
    # 'model' mesh axis (sequence parallelism — the beyond-paper collective
    # fix for replicated-head archs; requires an active mesh)
    act_shard: str = "none"
    # MoE dispatch sharding: "ep" pins (B,E,C,D) dispatch/combine buffers to
    # the expert-parallel axis (all-to-all movement); requires an active
    # mesh and n_experts % model_axis == 0
    moe_shard: str = "none"

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_heads % self.n_kv_heads == 0, "GQA group must divide"

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def subquadratic(self) -> bool:
        """Eligible for the long_500k cell (SSM / hybrid / linear-attn)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs are decoders or enc-dec

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks), for 6·N·D."""
        d, f, v, l = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        hq, hkv, hd = self.n_heads, self.n_kv_heads, self.head_dim
        embed = v * d * (1 if self.tied_embeddings else 2)
        attn = d * hq * hd + 2 * d * hkv * hd + hq * hd * d
        if self.is_moe:
            mlp = self.n_experts * 3 * d * f + d * self.n_experts
        elif f > 0:
            mlp = 3 * d * f
        else:  # xlstm-style integrated block: up(2x) + down
            mlp = 0
        if self.family == "ssm":
            # mLSTM block: up-proj 2D, mixer q/k/v/o on 2D, gates, down-proj
            di = 2 * d
            block = d * 2 * di + 3 * di * di // 1 + di * d
            core = l * block
        elif self.family == "hybrid":
            di = 2 * d
            n = self.ssm_state
            mamba = d * 2 * di + 2 * d * n + d * self.n_heads + di * d
            n_attn = l // max(1, self.attn_every)
            core = l * mamba + (attn + 3 * d * f)  # one shared attn+mlp
        else:
            core = l * (attn + mlp)
        if self.encoder_layers:
            core += self.encoder_layers * (attn + 4 * d * f // f * d if f else 0)
            core += self.encoder_layers * (attn + 2 * d * f)
            core += l * attn  # cross attention
        return embed + core

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if not self.is_moe:
            return self.param_count()
        d, f, l = self.d_model, self.d_ff, self.n_layers
        total = self.param_count()
        moe_all = l * self.n_experts * 3 * d * f
        moe_active = l * self.experts_per_token * 3 * d * f
        return total - moe_all + moe_active


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    small = dict(
        n_layers=min(cfg.n_layers, 4 if cfg.family in ("ssm", "hybrid") else 2),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(4, max(1, cfg.n_kv_heads * 4 // cfg.n_heads)),
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=256,
        dtype="float32",
        remat="none",
    )
    if cfg.is_moe:
        small.update(n_experts=4, experts_per_token=2)
    if cfg.ssm_state:
        small.update(ssm_state=8)
    if cfg.attn_every:
        small.update(attn_every=2)
    if cfg.slstm_every:
        small.update(slstm_every=2)
    if cfg.encoder_layers:
        small.update(encoder_layers=2, encoder_seq=16)
    if cfg.n_patches:
        small.update(n_patches=8)
    small["ssm_chunk"] = 16
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
