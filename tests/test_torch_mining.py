"""The port's mining on the CPU against the JAX package's, exactly.

Same sessions into both packages; the port runs on ``device="cpu"`` (its
plain join versions).  Bitmaps, pattern lists *in emission order*, and
the dynamic-minsup result must be equal."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from benchmarks.workloads import SEQB, TPCC, SEQBConfig, TPCCConfig  # noqa: E402
from repro.core import mining as jm  # noqa: E402
from repro.core.sessions import SequenceDatabase as JaxDB  # noqa: E402
from repro_torch.core import mining as tm  # noqa: E402
from repro_torch.core.sessions import SequenceDatabase as TorchDB  # noqa: E402


def random_sessions(seed=0, n_sessions=60, n_items=12, min_len=3,
                    max_len=10, planted=((1, 2, 3, 4), (5, 6, 7))):
    """Random sessions with planted frequent subsequences (the generator
    of tests/test_mining.py)."""
    rng = np.random.default_rng(seed)
    sessions = []
    for _ in range(n_sessions):
        s = list(rng.integers(0, n_items,
                              size=int(rng.integers(min_len, max_len + 1))))
        if rng.random() < 0.6 and planted:
            p = list(planted[int(rng.integers(0, len(planted)))])
            at = int(rng.integers(0, max(1, len(s) - len(p) + 1)))
            s[at:at + len(p)] = p
        sessions.append(s)
    return sessions


def seqb_sessions(n=150, seed=0):
    seqb = SEQB(SEQBConfig(n_blocks=2_000, n_frequent=24, seed=seed))
    return list(seqb.sessions(np.random.default_rng(seed + 1), n))


def tpcc_sessions(n=120, seed=0):
    gen = TPCC(TPCCConfig(customers_per_district=30, items=200,
                          orders_per_district=10, seed=seed))
    rng = np.random.default_rng(seed)
    return [[key for _, key in gen.transaction(rng)] for _ in range(n)]


def both(sessions):
    return JaxDB.from_sessions(sessions), TorchDB.from_sessions(sessions)


def listed(patterns):
    return [(p.items, p.support) for p in patterns]


def params_pair(**kw):
    return jm.MiningParams(**kw), tm.MiningParams(**kw)


# ---------------------------------------------------------------------------
# bitmaps and bit primitives
# ---------------------------------------------------------------------------


def assert_same_bitmaps(jvb, tvb):
    assert (tvb.n_sessions, tvb.n_words) == (jvb.n_sessions, jvb.n_words)
    assert tvb.bits.dtype == torch.int32
    np.testing.assert_array_equal(tvb.bits.numpy().view(np.uint32), jvb.bits)
    for field in ("freq_items", "freq_support", "_row_of"):
        a, b = getattr(jvb, field), getattr(tvb, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)


@pytest.mark.parametrize("stream", ["seqb", "tpcc", "long"])
@pytest.mark.parametrize("count", [1, 3])
def test_vertical_bitmaps_equal_reference(stream, count):
    sessions = {"seqb": seqb_sessions, "tpcc": tpcc_sessions,
                "long": lambda: random_sessions(n_items=40, max_len=90)}[
                    stream]()
    jdb, tdb = both(sessions)
    assert_same_bitmaps(jm.VerticalBitmaps(jdb, count),
                        tm.VerticalBitmaps(tdb, count, device="cpu"))


def test_empty_database_bitmaps_equal_reference():
    jdb, tdb = both([])
    assert_same_bitmaps(jm.VerticalBitmaps(jdb), tm.VerticalBitmaps(
        tdb, device="cpu"))


@pytest.mark.parametrize("maxgap", [1, 2, 3, None])
def test_bit_primitives_equal_reference_with_bit31(maxgap):
    rng = np.random.default_rng(7)
    words = rng.integers(0, 2 ** 32, size=(6, 9, 3), dtype=np.uint32)
    words[0] = 0
    words[1, :, 0] = 1 << 31                  # carries into the next word
    words[2, :, :2] = 0                       # first set bit in the last word
    words[3, :, 2] = 0xFFFFFFFF
    t = torch.from_numpy(words.view(np.int32))
    jvb = object.__new__(jm.VerticalBitmaps)
    tvb = object.__new__(tm.VerticalBitmaps)
    for got, want in [
        (tm.VerticalBitmaps.shift1(t), jm.VerticalBitmaps.shift1(words)),
        (tm.VerticalBitmaps.smear_after(t),
         jm.VerticalBitmaps.smear_after(words)),
        (tvb.extension_slots(t, maxgap), jvb.extension_slots(words, maxgap)),
    ]:
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(tm.VerticalBitmaps.support(t).numpy(),
                                  jm.VerticalBitmaps.support(words))


# ---------------------------------------------------------------------------
# ordered pattern lists
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("budget", [64 << 20, 1])
@pytest.mark.parametrize("minsup", [0.05, 0.1, 0.2])
@pytest.mark.parametrize("maxgap", [1, 2, None])
@pytest.mark.parametrize("algo", ["vmsp", "spam", "gsp"])
def test_pattern_lists_equal_reference(algo, maxgap, minsup, budget):
    jdb, tdb = both(random_sessions())
    jp, tp = params_pair(minsup=minsup, min_len=3, max_len=6, maxgap=maxgap,
                         frontier_budget=budget)
    want = listed(jm.mine(jdb, jp, algo))
    assert want
    assert listed(tm.mine(tdb, tp, algo, device="cpu")) == want


@pytest.mark.parametrize("algo", ["prefixspan", "vmsp"])
@pytest.mark.parametrize("stream", ["seqb", "tpcc"])
def test_workload_pattern_lists_equal_reference(algo, stream):
    sessions = seqb_sessions() if stream == "seqb" else tpcc_sessions()
    jdb, tdb = both(sessions)
    jp, tp = params_pair(minsup=0.03, min_len=2, max_len=15, maxgap=1)
    want = listed(jm.mine(jdb, jp, algo))
    assert want
    assert listed(tm.mine(tdb, tp, algo, device="cpu")) == want


@pytest.mark.parametrize("budget", [64 << 20, 1])
@pytest.mark.parametrize("stream", ["seqb", "tpcc"])
def test_dynamic_minsup_equals_reference(stream, budget):
    sessions = seqb_sessions() if stream == "seqb" else tpcc_sessions()
    jdb, tdb = both(sessions)
    jp, tp = params_pair(minsup=0.02, min_len=3, max_len=15, maxgap=1,
                         frontier_budget=budget)
    kw = dict(start=0.5, floor=0.01, min_patterns=12)
    jpat, jms = jm.mine_dynamic_minsup(jdb, jp, "vmsp", **kw)
    tpat, tms = tm.mine_dynamic_minsup(tdb, tp, "vmsp", device="cpu", **kw)
    assert jpat and jms < 0.5
    assert (listed(tpat), tms) == (listed(jpat), jms)


@pytest.mark.parametrize("algo", ["vmsp", "spam"])
def test_bitmaps_from_numpy_mine_like_reference(algo):
    """The reference's own bitmaps, carried across, mine identically."""
    jdb, tdb = both(random_sessions(seed=4))
    jp, tp = params_pair(minsup=0.1, min_len=3, max_len=6, maxgap=1)
    jvb = jm.VerticalBitmaps(jdb, 2)
    tvb = tm.bitmaps_from_numpy(jvb.bits, jvb.freq_items, jvb.freq_support,
                                jvb._row_of, jvb.n_sessions, jvb.n_words,
                                device="cpu")
    assert_same_bitmaps(jvb, tvb)
    want = listed(jm.mine(jdb, jp, algo, vb=jvb))
    assert listed(tm.mine(tdb, tp, algo, vb=tvb)) == want


def _planted_sessions():
    """tests/test_kernels.py's planted database."""
    rng = np.random.default_rng(5)
    sessions = []
    for _ in range(64):
        s = list(rng.integers(0, 8, size=rng.integers(3, 9)))
        if rng.random() < 0.5:
            s[:4] = [1, 2, 3, 4]
        sessions.append(s)
    return sessions


@pytest.mark.parametrize("budget", [64 << 20, 1])
def test_planted_database_equals_reference_kernel_run(budget):
    """Against the reference miner with its Pallas kernels (interpret
    mode): the frontier kernel, and the s-step kernel when spilling."""
    jdb, tdb = both(_planted_sessions())
    jp, tp = params_pair(minsup=0.1, min_len=3, max_len=6, maxgap=1,
                         frontier_budget=budget)
    want = listed(jm.ALGORITHMS["vmsp"](
        jdb, dataclasses.replace(jp, use_kernel=True)))
    assert want
    assert listed(tm.ALGORITHMS["vmsp"](tdb, tp, device="cpu")) == want


def test_bitmap_algorithms_default_to_cuda():
    """No device and no CUDA: mining refuses instead of using the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, tdb = both(random_sessions())
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.mine(tdb, tm.MiningParams())


# ---------------------------------------------------------------------------
# what the compacted frontier join lists
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("maxgap", [1, 2, None])
@pytest.mark.parametrize("stream", ["seqb", "tpcc", "long"])
def test_nonzero_slot_sessions_never_exceed_support(monkeypatch, stream,
                                                    maxgap):
    """The frontier kernel lists, for each prefix, the sessions where its
    slot words are nonzero.  At every level of the walk that count is at
    most the prefix's support as the walk holds it (``fsups``: a slot bit
    lies in a session where the prefix occurs), so a level's join work is
    bounded by numbers the host already has.  ``fsups`` is rebuilt here as
    the walk builds it: the frequent items' supports, then each level's
    surviving supports in row-major order."""
    sessions = {"seqb": seqb_sessions, "tpcc": tpcc_sessions,
                "long": lambda: random_sessions(n_items=40, max_len=90)}[
                    stream]()
    _, tdb = both(sessions)
    # without a gap bound, the long stream's lattice at minsup 0.05 runs
    # to tens of GB: there 0.3 and length 6 (three levels, up to 981
    # prefixes)
    wide = stream == "long" and maxgap is None
    params = tm.MiningParams(minsup=0.3 if wide else 0.05, min_len=2,
                             max_len=6 if wide else 15, maxgap=maxgap)
    levels = []
    join = tm._frontier_support

    def spy(slots, cand, cand_t, allowed=None):
        sup = join(slots, cand, cand_t, allowed)
        levels.append(((slots != 0).any(-1).sum(-1).numpy(), sup))
        return sup

    monkeypatch.setattr(tm, "_frontier_support", spy)
    assert tm.mine(tdb, params, "vmsp", device="cpu")
    msc = params.minsup_count(len(tdb))
    vb = tm.VerticalBitmaps(tdb, msc, device="cpu")
    fsups = vb.freq_support[vb.freq_support >= msc]
    assert len(levels) >= 2
    for nonzero, sup in levels:
        assert nonzero.shape == fsups.shape
        assert (nonzero <= fsups).all()
        assert nonzero.sum() > 0
        fsups = sup[sup >= msc]


@pytest.mark.parametrize("stream", ["seqb", "tpcc", "long"])
@pytest.mark.parametrize("maxgap", [1, None])
def test_spill_slot_sessions_never_exceed_node_support(monkeypatch, stream,
                                                       maxgap):
    """On the DFS spill walk each node joins its slot row against every
    candidate with ``sstep_join_support``; the row is nonzero in at most
    the node's support of sessions (a slot bit lies in a session where the
    node's pattern occurs), so the s-step kernel, which reads a candidate
    word only beside a nonzero slot word, reads at most support x K of
    them.  Every s-step call of the walk is checked against the support
    its node was reached with."""
    sessions = {"seqb": seqb_sessions, "tpcc": tpcc_sessions,
                "long": lambda: random_sessions(n_items=40, max_len=90)}[
                    stream]()
    _, tdb = both(sessions)
    wide = stream == "long" and maxgap is None
    params = tm.MiningParams(minsup=0.3 if wide else 0.05, min_len=2,
                             max_len=6 if wide else 15, maxgap=maxgap,
                             frontier_budget=1)
    nodes, calls = [], []
    expand, join = tm._dfs_expand, tm._ops.sstep_join_support

    def spy_expand(vb, params, msc, cand, cand_items, pattern, pbits, sup,
                   *rest):
        nodes.append((int((pbits != 0).any(-1).sum()), int(sup)))
        return expand(vb, params, msc, cand, cand_items, pattern, pbits, sup,
                      *rest)

    def spy_join(slots, cand):
        calls.append((len(nodes), int((slots != 0).any(-1).sum())))
        return join(slots, cand)

    monkeypatch.setattr(tm, "_dfs_expand", spy_expand)
    monkeypatch.setattr(tm._ops, "sstep_join_support", spy_join)
    assert tm.mine(tdb, params, "vmsp", device="cpu")
    assert calls
    for node, nonzero in calls:
        occurs, sup = nodes[node - 1]     # the node that made this call
        assert occurs == sup
        assert nonzero <= sup
