"""Batched serving engine: prefill + decode loop with sampling.

The port of ``src/repro/serving/engine.py``.  A request is one prefill
(for dense and moe one pass over the layers that fills the KV cache and
unembeds the last position; for ssm and hybrid the chunked full-sequence
pass, with the cache left as the reference's ``fill_cache`` leaves it;
with ``attention_impl="pallas"`` every prefill attention runs a Hopper
flash-attention kernel) and then one ``decode_step`` per new token, with
the cache kept on the device and updated in place.

Sampling: greedy ``argmax`` (the first maximum, as ``jnp.argmax``) when
``temperature <= 0``; otherwise a categorical draw from a
``torch.Generator`` seeded with ``ServeConfig.seed`` at the start of each
``generate``.  Greedy tokens equal the reference's; JAX's
``jax.random.categorical`` stream cannot be reproduced in torch, so a
sampled continuation is only deterministic under its seed.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..core.obs import (
    METRIC_DECODE_S,
    METRIC_PREFILL_S,
    METRIC_TOKENS,
    MetricsRegistry,
)
from ..device import resolve_device
from ..models import decode_step, prefill

__all__ = ["ServeConfig", "ServingEngine"]

#: prefill/decode timings are host seconds of real compute (ended by a
#: device synchronize): telemetry that never feeds simulated time
_telemetry_clock = time.perf_counter


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 512
    temperature: float = 0.0       # 0 = greedy
    seed: int = 0


class ServingEngine:
    """Serves ``model`` (a model of a family that takes tokens only:
    :class:`repro_torch.models.DenseLM` for dense and moe,
    :class:`~repro_torch.models.XLSTMLM` for ssm,
    :class:`~repro_torch.models.ZambaLM` for hybrid) on ``device``
    (default ``cuda``; the model must already be there)."""

    def __init__(self, cfg, model, serve_cfg: Optional[ServeConfig] = None,
                 device=None):
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model on {model.device}, engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.model = model
        self.scfg = serve_cfg or ServeConfig()
        self.metrics = MetricsRegistry()
        self._prefill_s = self.metrics.gauge(METRIC_PREFILL_S)
        self._decode_s = self.metrics.gauge(METRIC_DECODE_S)
        self._tokens = self.metrics.counter(METRIC_TOKENS)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def generate(self, prompts: np.ndarray, new_tokens: int) -> np.ndarray:
        """prompts: (B, S) integer array.  Returns (B, new_tokens) int32."""
        b, s = prompts.shape
        if s + new_tokens > self.scfg.max_len:
            raise ValueError(f"prompt {s} + {new_tokens} new tokens exceed "
                             f"max_len {self.scfg.max_len}")
        tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                                 device=self.device)
        t0 = _telemetry_clock()
        logits, cache = prefill(self.cfg, self.model, {"tokens": tokens},
                                self.scfg.max_len)
        self._sync()
        self._prefill_s.set(self._prefill_s.value + _telemetry_clock() - t0)

        gen = torch.Generator(device=self.device).manual_seed(self.scfg.seed)
        out = []
        t0 = _telemetry_clock()
        # new_tokens decode steps, as the reference times them: the last
        # one's logits go unused
        for _ in range(new_tokens):
            tok = self._sample(logits, gen)
            out.append(tok)
            logits, cache = decode_step(self.cfg, self.model, cache, tok)
        result = (torch.cat(out, dim=1) if out else
                  torch.empty((b, 0), dtype=torch.int64, device=self.device))
        result = result.to(torch.int32).cpu().numpy()
        self._decode_s.set(self._decode_s.value + _telemetry_clock() - t0)
        self._tokens.inc(b * new_tokens)
        return result

    def _sample(self, logits: torch.Tensor,
                gen: torch.Generator) -> torch.Tensor:
        logits = logits[:, -1, :].float()
        if self.scfg.temperature <= 0:
            return torch.argmax(logits, dim=-1, keepdim=True)
        probs = torch.softmax(logits / self.scfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)

    @property
    def stats(self) -> dict:
        """Registry snapshot as the reference's dict shape."""
        snap = self.metrics.snapshot()
        return {"prefill_s": snap[METRIC_PREFILL_S],
                "decode_s": snap[METRIC_DECODE_S],
                "tokens": snap[METRIC_TOKENS]}

    @property
    def tokens_per_s(self) -> float:
        d = self._decode_s.value
        return self._tokens.value / d if d > 0 else 0.0
