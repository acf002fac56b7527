"""Architecture registry: one module per assigned architecture.

Copied unchanged from ``src/repro/configs/__init__.py``.
"""

from .base import SHAPES, ModelConfig, ShapeConfig, reduced
from . import (
    codeqwen15_7b,
    command_r_35b,
    grok_1_314b,
    llava_next_mistral_7b,
    qwen3_moe_235b,
    stablelm_1_6b,
    whisper_large_v3,
    xlstm_1_3b,
    yi_34b,
    zamba2_7b,
)

REGISTRY = {
    m.CONFIG.name: m.CONFIG
    for m in (
        xlstm_1_3b, grok_1_314b, qwen3_moe_235b, stablelm_1_6b, yi_34b,
        command_r_35b, codeqwen15_7b, zamba2_7b, whisper_large_v3,
        llava_next_mistral_7b,
    )
}

ARCH_IDS = tuple(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


__all__ = [
    "ARCH_IDS", "REGISTRY", "SHAPES", "ModelConfig", "ShapeConfig",
    "get_config", "reduced",
]
