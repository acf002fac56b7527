"""The port's support joins against the JAX package's on the CPU.

On CPU tensors the port's wrappers run their plain PyTorch versions; they
must equal the JAX kernels (interpret mode, as tests/test_kernels.py runs
them) and the JAX package's oracles exactly, on the same grids, among
them ``chip_smoke.frontier_cases``, the sparse grid that phase 2 of
``chip_smoke.py`` and tests/test_torch_cuda.py hold the CUDA kernel to on
a card.  The frontier kernel's grid (``ops.frontier_plan``) is checked
here by laying its blocks out in numpy.  Every equality is exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import chip_smoke  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.bitmap_support import ops as jax_ops  # noqa: E402
from repro.kernels.bitmap_support import ref as jax_ref  # noqa: E402
from repro_torch.kernels.bitmap_support import ops, ref  # noqa: E402

SSTEP_GRID = [(1, 7, 1), (5, 100, 3), (8, 512, 1), (9, 513, 2),
              (32, 1000, 4), (3, 1, 1)]
FRONTIER_GRID = [(1, 1, 7, 1), (5, 9, 100, 2), (8, 8, 128, 1),
                 (9, 17, 130, 3), (16, 32, 512, 1), (3, 2, 1, 1)]
#: (name, slots, cand) uint32: 0, 1, 10 and 100% of (prefix, session)
#: pairs nonzero, one prefix in every session among empty ones, only the
#: last of W > 1 words set, bit 31 only
SPARSE = chip_smoke.frontier_cases(np.random.default_rng(3))


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



@pytest.mark.parametrize("case", range(len(SPARSE)),
                         ids=[name for name, _, _ in SPARSE])
def test_frontier_plain_matches_numpy_on_the_sparse_grid(case):
    name, slots, cand = SPARSE[case]
    got = ops.frontier_join_support(as_torch(slots), as_torch(cand))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), jax_ref.frontier_join_support(slots, cand))
    assert got.numpy().any() != name.startswith("0%")


def plan_blocks(plan: ops.FrontierPlan, p_prefixes, k_items, n_sessions):
    """The kernel's blocks, decoded from the block index as the kernel
    does: (prefix rows, sessions, candidates) of each."""
    span = ops._JOIN_THREADS
    for b in range(plan.blocks):
        r = b % plan.n_ranges
        tile = b // plan.n_ranges % plan.n_tiles
        chunk = b // plan.n_ranges // plan.n_tiles
        per_chunk = plan.kpt * ops._JOIN_THREADS
        yield (np.arange(tile * ops._TILE_ROWS,
                         min(p_prefixes, (tile + 1) * ops._TILE_ROWS)),
               np.arange(r * span, min(n_sessions, (r + 1) * span)),
               np.arange(chunk * per_chunk,
                         min(k_items, (chunk + 1) * per_chunk)))


@pytest.mark.parametrize("p_prefixes,k_items,n_sessions", [
    (1, 1, 1), (8, 256, 256), (9, 257, 257), (20, 300, 700),
    (17, 700, 600), (9, 1100, 300), (3, 5000, 40), (467, 467, 10_000)])
def test_frontier_plan_covers_every_pair_once(p_prefixes, k_items,
                                              n_sessions):
    """Every (prefix, session, candidate) lies in exactly one block, and
    no block holds more than 8 prefixes, 256 sessions or 256 * kpt
    candidates, with kpt the least of 1, 2, 4 that holds K."""
    plan = ops.frontier_plan(p_prefixes, k_items, n_sessions)
    assert plan.kpt == min([c for c in (1, 2, 4) if k_items <= 256 * c]
                           or [4])
    cover = [np.zeros(n, np.int64) for n in (p_prefixes, n_sessions,
                                             k_items)]
    tiles = set()
    for rows, sess, cands in plan_blocks(plan, p_prefixes, k_items,
                                         n_sessions):
        assert 0 < rows.size <= 8 and 0 < sess.size <= 256
        assert 0 < cands.size <= 256 * plan.kpt
        key = (rows[0], sess[0], cands[0])
        assert key not in tiles
        tiles.add(key)
        for c, part in zip(cover, (rows, sess, cands)):
            c[part] += 1
    # the blocks are the product of three partitions, each covering its
    # axis the same number of times: so each triple exactly once
    per = plan.blocks
    for c, n in zip(cover, (plan.n_tiles, plan.n_ranges, plan.k_chunks)):
        assert (c == per // n).all()


def emulate_blocks(slots: np.ndarray, cand: np.ndarray):
    """The frontier kernel's work, block by block, in numpy: each block
    lists the sessions of its range where its tile has a nonzero word, in
    order, and adds one to (p, k) for each listed session where the AND
    is nonzero.  Returns the support and each block's list."""
    p_prefixes, n_sessions, _ = slots.shape
    k_items = cand.shape[0]
    cand_t = cand.transpose(1, 0, 2)
    plan = ops.frontier_plan(p_prefixes, k_items, n_sessions)
    out = np.zeros((p_prefixes, k_items), np.int64)
    lists = []
    for rows, sess, cands in plan_blocks(plan, p_prefixes, k_items,
                                         n_sessions):
        tile = slots[rows][:, sess]                           # (r, n, W)
        listed = sess[(tile != 0).any(axis=(0, 2))]
        lists.append((rows, sess, listed))
        hit = slots[rows][:, listed, None, :] & cand_t[listed][None, :, cands]
        out[np.ix_(rows, cands)] += (hit != 0).any(-1).sum(1)
    return out, lists


@pytest.mark.parametrize("case", range(len(SPARSE)),
                         ids=[name for name, _, _ in SPARSE])
def test_frontier_blocks_list_each_nonzero_pair_once(case):
    """Laid out as the kernel's blocks, the lists hold each (prefix,
    session) with a nonzero slot word once, a tile that is empty over a
    range lists nothing there, and the counts add up to the plain
    version's."""
    _, slots, cand = SPARSE[case]
    got, lists = emulate_blocks(slots, cand)
    np.testing.assert_array_equal(
        got, jax_ref.frontier_join_support(slots, cand))
    listed = np.zeros(slots.shape[:2], np.int64)
    k_chunks = ops.frontier_plan(*slots.shape[:1], cand.shape[0],
                                 slots.shape[1]).k_chunks
    for rows, sess, sess_listed in lists:
        nonzero = (slots[rows][:, sess] != 0).any(-1)          # (r, n)
        assert np.array_equal(sess_listed, sess[nonzero.any(0)])
        on = np.isin(sess, sess_listed)
        listed[np.ix_(rows, sess[on])] += nonzero[:, on]
    np.testing.assert_array_equal(
        listed, k_chunks * (slots != 0).any(-1).astype(np.int64))


def test_session_major_copy_and_its_checks():
    """On the CPU there is no copy to make: the plain version reads cand
    as it is.  A copy of another shape is refused on every device."""
    slots = torch.zeros((2, 5, 3), dtype=torch.int32)
    cand = torch.zeros((4, 5, 3), dtype=torch.int32)
    assert ops.session_major(cand) is None
    good = cand.transpose(0, 1).contiguous()
    assert ops.frontier_join_support(slots, cand, good).shape == (2, 4)
    for bad, err in [(cand, ValueError), (good[:, :3], ValueError),
                     (good.to(torch.int64), TypeError),
                     (cand.permute(1, 0, 2), ValueError)]:
        with pytest.raises(err):
            ops.frontier_join_support(slots, cand, bad)


#: chip_smoke.py's sparse grid for the s-step kernel: slot rows nonzero in
#: 0.4%, 1%, 12.6% and all of the sessions
SSTEP_SPARSE = chip_smoke.sstep_cases(np.random.default_rng(4))


@pytest.mark.parametrize("k_items,n_sessions,n_words,aligned", [
    (1, 1, 1, True), (467, 10_000, 1, True), (467, 10_000, 1, False),
    (70, 4_099, 1, True), (33, 1_000, 3, True), (5_000, 40, 1, True),
    (3, 1_025, 1, True), (2, 100_000, 2, True)])
def test_sstep_plan_covers_every_pair_once(k_items, n_sessions, n_words,
                                           aligned):
    """Ranges of 256 threads tile the sessions (4 one-word sessions a
    thread where the layout allows it), blocks of at most 32 candidates
    tile K, and neither leaves a block empty."""
    plan = ops.sstep_plan(k_items, n_sessions, n_words, aligned)
    assert plan.vec == (4 if n_words == 1 and n_sessions % 4 == 0
                        and aligned else 1)
    span = 256 * plan.vec
    assert (plan.n_ranges - 1) * span < n_sessions <= plan.n_ranges * span
    assert 1 <= plan.k_per_block <= 32
    assert ((plan.k_blocks - 1) * plan.k_per_block < k_items
            <= plan.k_blocks * plan.k_per_block)
    assert plan.blocks == plan.n_ranges * plan.k_blocks


def emulate_sstep_blocks(slots: np.ndarray, cand: np.ndarray):
    """The s-step kernel's work, block by block, in numpy: each block reads
    its slot words once and, for each of its candidates, the candidate
    words beside nonzero slot words only.  Returns joined, support and
    the candidate words read."""
    n_sessions, n_words = slots.shape
    k_items = cand.shape[0]
    plan = ops.sstep_plan(k_items, n_sessions, n_words)
    span = 256 * plan.vec
    joined = np.zeros_like(cand)
    support = np.zeros(k_items, np.int64)
    read = 0
    for r in range(plan.n_ranges):
        sess = slice(r * span, min(n_sessions, (r + 1) * span))
        sw = slots[sess]
        nz = sw != 0
        for kb in range(plan.k_blocks):
            for k in range(kb * plan.k_per_block,
                           min(k_items, (kb + 1) * plan.k_per_block)):
                joined[k, sess][nz] = sw[nz] & cand[k, sess][nz]
                read += int(nz.sum())
                support[k] += int((joined[k, sess] != 0).any(-1).sum())
    return joined, support, read


@pytest.mark.parametrize("case", range(len(SSTEP_SPARSE)),
                         ids=[name for name, _, _ in SSTEP_SPARSE])
def test_sstep_plain_and_blocks_match_jax_on_the_sparse_grid(case):
    """The plain version equals the JAX package's oracle on the sparse
    grid; laid out as the kernel's blocks, reading only the candidate
    words beside nonzero slot words gives the same bits and supports, and
    reads (nonzero slot words) x K words."""
    _, slots, cand = SSTEP_SPARSE[case]
    want_joined, want_sup = jax_ref.sstep_join_support(jnp.asarray(slots),
                                                       jnp.asarray(cand))
    joined, sup = ops.sstep_join_support(as_torch(slots), as_torch(cand))
    np.testing.assert_array_equal(as_u32(joined), np.asarray(want_joined))
    np.testing.assert_array_equal(sup.numpy(), np.asarray(want_sup))
    got_joined, got_sup, read = emulate_sstep_blocks(slots, cand)
    np.testing.assert_array_equal(got_joined, np.asarray(want_joined))
    np.testing.assert_array_equal(got_sup, np.asarray(want_sup))
    assert read == int((slots != 0).sum()) * cand.shape[0]
