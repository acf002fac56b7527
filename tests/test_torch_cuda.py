"""The CUDA kernels against their plain versions, on a card.

Marked ``cuda``: without a card the tests skip.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import mining  # noqa: E402
from repro_torch.core.sessions import SequenceDatabase  # noqa: E402
from repro_torch.kernels.bitmap_support import ops, ref  # noqa: E402

pytestmark = pytest.mark.cuda

#: tests/test_kernels.py's grids, then ragged tiles, split sessions and
#: sessions wider than one staged chunk of the frontier kernel
SSTEP_GRID = [(1, 7, 1), (5, 100, 3), (8, 512, 1), (9, 513, 2),
              (32, 1000, 4), (3, 1, 1), (70, 5000, 1), (4, 300, 70)]
FRONTIER_GRID = [(1, 1, 7, 1), (5, 9, 100, 2), (8, 8, 128, 1),
                 (9, 17, 130, 3), (16, 32, 512, 1), (3, 2, 1, 1),
                 (33, 65, 300, 2), (3, 5, 20_000, 1), (4, 33, 50, 70),
                 (40, 40, 3000, 130)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def words(rng, shape) -> torch.Tensor:
    w = rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)
    return torch.from_numpy(w.view(np.int32)).cuda()


@pytest.mark.parametrize("k_items,n_sessions,n_words", SSTEP_GRID)
def test_sstep_kernel_equals_plain(card, k_items, n_sessions, n_words):
    rng = np.random.default_rng(k_items * 1000 + n_sessions)
    slots = words(rng, (n_sessions, n_words))
    cand = words(rng, (k_items, n_sessions, n_words))
    joined, sup = ops.sstep_join_support(slots, cand)
    torch.cuda.synchronize()
    want_joined, want_sup = ref.sstep_join_support(slots, cand)
    assert torch.equal(joined, want_joined)
    assert torch.equal(sup, want_sup)


@pytest.mark.parametrize("p_prefixes,k_items,n_sessions,n_words",
                         FRONTIER_GRID)
def test_frontier_kernel_equals_plain(card, p_prefixes, k_items, n_sessions,
                                      n_words):
    rng = np.random.default_rng(p_prefixes * 1000 + k_items + n_sessions)
    slots = words(rng, (p_prefixes, n_sessions, n_words))
    cand = words(rng, (k_items, n_sessions, n_words))
    got = ops.frontier_join_support(slots, cand)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.frontier_join_support(slots, cand))


@pytest.mark.parametrize("budget", [64 << 20, 1])
def test_mining_on_the_card_uses_the_kernels_and_equals_cpu(card, budget):
    rng = np.random.default_rng(5)
    sessions = [list(rng.integers(0, 30, size=int(rng.integers(3, 60))))
                for _ in range(300)]
    db = SequenceDatabase.from_sessions(sessions)
    params = mining.MiningParams(minsup=0.02, min_len=2, max_len=8,
                                 maxgap=1, frontier_budget=budget)
    on_cpu = mining.mine(db, params, "vmsp", device="cpu")
    kernel = "frontier_join_support" if budget > 1 else "sstep_join_support"
    before = dict(ops.counts), dict(ref.counts)
    on_card = mining.mine(db, params, "vmsp", device="cuda")
    assert on_card == on_cpu and on_card
    assert ops.counts[kernel] > before[0][kernel]
    assert ref.counts == before[1]
    cpu_vb = mining.VerticalBitmaps(db, 2, device="cpu")
    card_vb = mining.VerticalBitmaps(db, 2, device="cuda")
    assert torch.equal(card_vb.bits.cpu(), cpu_vb.bits)
    for field in ("freq_items", "freq_support", "_row_of"):
        np.testing.assert_array_equal(getattr(card_vb, field),
                                      getattr(cpu_vb, field))
