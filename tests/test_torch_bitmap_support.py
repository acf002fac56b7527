"""The port's support joins against the JAX package's on the CPU.

On CPU tensors the port's wrappers run their plain PyTorch versions; they
must equal the JAX kernels (interpret mode, as tests/test_kernels.py runs
them) and the JAX package's oracles exactly, on the same grids.  The CUDA
kernels themselves are held against these on a card, in
tests/test_torch_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.bitmap_support import ops as jax_ops  # noqa: E402
from repro.kernels.bitmap_support import ref as jax_ref  # noqa: E402
from repro_torch.kernels.bitmap_support import ops, ref  # noqa: E402

SSTEP_GRID = [(1, 7, 1), (5, 100, 3), (8, 512, 1), (9, 513, 2),
              (32, 1000, 4), (3, 1, 1)]
FRONTIER_GRID = [(1, 1, 7, 1), (5, 9, 100, 2), (8, 8, 128, 1),
                 (9, 17, 130, 3), (16, 32, 512, 1), (3, 2, 1, 1)]


def as_torch(words: np.ndarray) -> torch.Tensor:
    """uint32 words -> the port's int32 words (same bits)."""
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


def as_u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("k_items,n_sessions,n_words", SSTEP_GRID)
def test_sstep_plain_matches_jax(k_items, n_sessions, n_words):
    rng = np.random.default_rng(k_items * 1000 + n_sessions)
    slots = rng.integers(0, 2 ** 32, size=(n_sessions, n_words),
                         dtype=np.uint32)
    cand = rng.integers(0, 2 ** 32, size=(k_items, n_sessions, n_words),
                        dtype=np.uint32)
    joined, sup = ops.sstep_join_support(as_torch(slots), as_torch(cand))
    kj, ks = jax_ops.sstep_join_support(slots, cand)
    rj, rs = jax_ref.sstep_join_support(jnp.asarray(slots), jnp.asarray(cand))
    assert joined.dtype == torch.int32 and sup.dtype == torch.int32
    np.testing.assert_array_equal(as_u32(joined), np.asarray(kj))
    np.testing.assert_array_equal(as_u32(joined), np.asarray(rj))
    np.testing.assert_array_equal(sup.numpy(), np.asarray(ks))
    np.testing.assert_array_equal(sup.numpy(), np.asarray(rs))


@pytest.mark.parametrize("p_prefixes,k_items,n_sessions,n_words",
                         FRONTIER_GRID)
def test_frontier_plain_matches_jax(p_prefixes, k_items, n_sessions,
                                    n_words):
    rng = np.random.default_rng(p_prefixes * 1000 + k_items + n_sessions)
    slots = rng.integers(0, 2 ** 32, size=(p_prefixes, n_sessions, n_words),
                         dtype=np.uint32)
    cand = rng.integers(0, 2 ** 32, size=(k_items, n_sessions, n_words),
                        dtype=np.uint32)
    got = ops.frontier_join_support(as_torch(slots), as_torch(cand))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_ops.frontier_join_support(slots, cand)))
    np.testing.assert_array_equal(
        got.numpy(), jax_ref.frontier_join_support(slots, cand))


def test_frontier_plain_chunks_agree():
    """A budget smaller than one prefix's join still chunks exactly."""
    rng = np.random.default_rng(3)
    slots = rng.integers(0, 2 ** 32, size=(7, 40, 2), dtype=np.uint32)
    cand = rng.integers(0, 2 ** 32, size=(5, 40, 2), dtype=np.uint32)
    whole = ref.frontier_join_support(as_torch(slots), as_torch(cand))
    tiny = ref.frontier_join_support(as_torch(slots), as_torch(cand),
                                     budget=1)
    assert torch.equal(whole, tiny)
    np.testing.assert_array_equal(
        whole.numpy(), jax_ref.frontier_join_support(slots, cand))


def test_sparse_and_empty_edges_match_jax():
    slots = np.zeros((2, 64, 2), np.uint32)
    cand = np.zeros((3, 64, 2), np.uint32)
    cand[1, 3, 0] = 1                          # a bit the slots lack
    slots[1, 40, 1] = cand[2, 40, 1] = 1 << 31
    got = ops.frontier_join_support(as_torch(slots), as_torch(cand))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_ops.frontier_join_support(slots, cand)))
    assert got.tolist() == [[0, 0, 0], [0, 0, 1]]
    j, s = ops.sstep_join_support(as_torch(slots[1]), as_torch(cand))
    kj, ks = jax_ops.sstep_join_support(slots[1], cand)
    np.testing.assert_array_equal(as_u32(j), np.asarray(kj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ks))
    assert ops.frontier_join_support(
        as_torch(slots[:0]), as_torch(cand)).shape == (0, 3)
    assert ops.frontier_join_support(
        as_torch(slots), as_torch(cand[:0])).shape == (2, 0)
    j, s = ops.sstep_join_support(as_torch(slots[0]), as_torch(cand[:0]))
    assert j.shape == (0, 64, 2) and s.shape == (0,)


def test_cpu_tensors_take_the_plain_version_and_count_it():
    slots = torch.zeros((2, 5, 1), dtype=torch.int32)
    cand = torch.zeros((3, 5, 1), dtype=torch.int32)
    kernel_before = dict(ops.counts)
    plain_before = dict(ref.counts)
    ops.frontier_join_support(slots, cand)
    ops.sstep_join_support(slots[0], cand)
    assert ops.counts == kernel_before
    assert ref.counts["frontier_join_support"] == \
        plain_before["frontier_join_support"] + 1
    assert ref.counts["sstep_join_support"] == \
        plain_before["sstep_join_support"] + 1


@pytest.mark.parametrize("bad,err", [
    (lambda s, c: (s.to(torch.int64), c), TypeError),          # dtype
    (lambda s, c: (s[..., None], c), ValueError),              # rank
    (lambda s, c: (s.transpose(0, 1), c), ValueError),         # layout
    (lambda s, c: (s, c[:, :4]), ValueError),                  # shape
])
def test_wrappers_reject_what_the_kernels_do_not_take(bad, err):
    slots = torch.zeros((5, 5, 1), dtype=torch.int32)
    cand = torch.zeros((3, 5, 1), dtype=torch.int32)
    s, c = bad(slots, cand)
    with pytest.raises(err):
        ops.frontier_join_support(s, c)

