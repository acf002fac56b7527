"""Plain PyTorch versions of the VMSP support joins.

The port's counterpart of ``src/repro/kernels/bitmap_support/ref.py``.
Words are ``int32`` tensors holding the reference's ``uint32`` bits.  The
CPU path of :mod:`.ops` runs these, and ``chip_smoke.py`` holds the CUDA
kernels against them on the card.  Each keeps a launch count, so a run
can show that the main path on the card never took them.
"""

from __future__ import annotations

import torch

__all__ = ["sstep_join_support", "frontier_join_support", "counts"]

#: byte cap on the dense (chunk, K, S, W) join transient, the default of
#: ``MiningParams.frontier_budget``
FRONTIER_BUDGET = 64 * 1024 * 1024

#: calls of each plain version since the last reset
counts = {"sstep_join_support": 0, "frontier_join_support": 0}


def sstep_join_support(
    slots: torch.Tensor, cand: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(S, W) × (K, S, W) -> joined (K, S, W) int32, support (K,) int32.

    ``joined[k]`` is ``slots & cand[k]``; ``support[k]`` counts the
    sessions where any word of ``joined[k]`` is nonzero."""
    counts["sstep_join_support"] += 1
    joined = slots[None] & cand
    support = (joined != 0).any(-1).sum(-1, dtype=torch.int32)
    return joined, support


def frontier_join_support(
    slots: torch.Tensor, cand: torch.Tensor, budget: int = FRONTIER_BUDGET
) -> torch.Tensor:
    """(P, S, W) × (K, S, W) -> support (P, K) int32.

    ``support[p, k]`` counts the sessions where any word of
    ``slots[p] & cand[k]`` is nonzero.  Chunked over P so the
    (chunk, K, S, W) transient stays under ``budget`` bytes."""
    counts["frontier_join_support"] += 1
    p_prefixes, n_sessions, n_words = slots.shape
    k_items = cand.shape[0]
    out = torch.zeros((p_prefixes, k_items), dtype=torch.int32,
                      device=slots.device)
    if p_prefixes == 0 or k_items == 0:
        return out
    chunk = max(1, budget // max(1, k_items * n_sessions * n_words * 4))
    for p0 in range(0, p_prefixes, chunk):
        joined = slots[p0:p0 + chunk, None] & cand[None]
        out[p0:p0 + chunk] = (joined != 0).any(-1).sum(-1, dtype=torch.int32)
    return out
