"""The port's decision walk against the JAX package's on the CPU.

``repro_torch.kernels.decision_walk`` (torch operations on
``device="cpu"``) against ``repro.kernels.decision_walk`` (jitted on the
CPU) and both numpy references, over the grid of
``tests/test_decision_kernel.py``; then the port's ``"torch"``-backend
engine in lockstep with the scalar engine, the numpy engine and the
reference's ``backend="jax"`` engine.  Each package builds its index from
the same pattern list.  Everything is exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.core as jc  # noqa: E402
import repro_torch.core as tc  # noqa: E402
from repro.kernels.decision_walk import ops as jax_ops  # noqa: E402
from repro.kernels.decision_walk import ref as jax_ref  # noqa: E402
from repro_torch.kernels.decision_walk import ops, ref  # noqa: E402

from test_decision import seqb_stream, tpcc_stream  # noqa: E402

KEYS = ("found", "stay", "nodes", "alive", "fetched", "wave_nodes")
HEURISTICS = [("fetch_all", {}), ("fetch_top_n", {"top_n": 3}),
              ("fetch_progressive", {"progressive_depth": 2})]


def random_patterns(seed, n_patterns=None, alphabet=24, max_len=6):
    """``test_decision.random_index``'s patterns, as (items, support)."""
    rng = np.random.default_rng(seed)
    n = n_patterns or int(rng.integers(3, 14))
    pats = []
    for _ in range(n):
        ln = int(rng.integers(1, max_len + 1))
        items = tuple(int(x) for x in rng.integers(0, alphabet, size=ln))
        pats.append((items, int(rng.integers(1, 40))))
    return pats


def indexes(seed, n_patterns=None):
    """(reference index, port index) built from the same patterns."""
    pats = random_patterns(seed, n_patterns)
    return tuple(pkg.PTreeIndex.build([pkg.Pattern(i, s) for i, s in pats])
                 for pkg in (jc, tc))


def live_states(flat, rng, n):
    """``test_decision_kernel.live_states``: any non-leaf node, fetched
    between its depth and the tree's max."""
    cand = np.flatnonzero(flat.n_children > 0)
    nodes = cand[rng.integers(0, len(cand), size=n)]
    trees = flat.tree_of[nodes]
    lo = flat.depth[nodes]
    hi = flat.tree_max_depth[trees]
    fetched = lo + (rng.random(n) * (hi - lo + 1)).astype(np.int64)
    return nodes, trees, fetched


def assert_states_equal(got, want, what):
    for key in KEYS:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]),
                                      err_msg=f"{what}: {key}")


@pytest.mark.parametrize("seed", range(5))
def test_decision_walk_matches_jax_and_both_references(seed):
    rng = np.random.default_rng(seed)
    jidx, tidx = indexes(seed, n_patterns=12)
    jflat, tflat = jidx.flatten(), tidx.flatten()
    assert tflat.n_nodes > 0 and (tflat.n_children > 0).any()
    jf = jax_ops.device_forest(jflat)
    tf = ops.device_forest(tflat, device="cpu")
    for trial in range(8):
        n = int(rng.integers(1, 9))
        nodes, trees, fetched = live_states(tflat, rng, n)
        item = int(rng.integers(-2, tflat.item_stride + 3))
        p_depth = int(rng.integers(1, 4))
        got = ops.decision_walk(tf, tflat, nodes, trees, fetched, item,
                                p_depth, max_contexts=16)
        what = f"seed {seed} trial {trial} item {item}"
        assert_states_equal(got, jax_ops.decision_walk(
            jf, jflat, nodes, trees, fetched, item, p_depth,
            max_contexts=16), what + " vs jax")
        assert_states_equal(got, jax_ref.decision_walk_ref(
            jflat, nodes, trees, fetched, item, p_depth), what + " vs jax ref")
        assert_states_equal(got, ref.decision_walk_ref(
            tflat, nodes, trees, fetched, item, p_depth), what + " vs ref")


@pytest.mark.parametrize("seed", range(3))
def test_interpret_runs_the_numpy_reference(seed):
    rng = np.random.default_rng(seed)
    _, tidx = indexes(seed, n_patterns=12)
    flat = tidx.flatten()
    tf = ops.device_forest(flat, device="cpu")
    for _ in range(4):
        n = int(rng.integers(1, 9))
        nodes, trees, fetched = live_states(flat, rng, n)
        item = int(rng.integers(-2, flat.item_stride + 3))
        assert_states_equal(
            ops.decision_walk(tf, flat, nodes, trees, fetched, item, 2,
                              max_contexts=16),
            ops.decision_walk(tf, flat, nodes, trees, fetched, item, 2,
                              max_contexts=16, interpret=True), "interpret")


def test_empty_edge_table_gets_the_sentinel():
    flat = tc.PTreeIndex.build([]).flatten()
    tf = ops.device_forest(flat, device="cpu")
    assert tf.edge_keys.tolist() == [np.iinfo(np.int64).max]
    out = ops.decision_walk(tf, flat, np.empty(0, np.int64),
                            np.empty(0, np.int64), np.empty(0, np.int64), 3,
                            2, max_contexts=4)
    assert out["wave_nodes"].size == 0 and out["alive"].size == 0


def test_root_contexts_match_jax():
    """Every context at its tree's root: a child's item advances one, the
    root's own item keeps it, an item of neither (or out of range) ends
    it."""
    pats = [((5, 6), 3), ((7, 8), 2)]
    jflat, tflat = (pkg.PTreeIndex.build([pkg.Pattern(i, s) for i, s in pats])
                    .flatten() for pkg in (jc, tc))
    tf = ops.device_forest(tflat, device="cpu")
    jf = jax_ops.device_forest(jflat)
    roots = tflat.tree_start[:-1]
    trees = np.arange(len(roots))
    for item in (5, 6, 7, 8, 9, -1):
        fetched = np.ones(len(roots), np.int64)
        assert_states_equal(
            ops.decision_walk(tf, tflat, roots, trees, fetched, item, 1,
                              max_contexts=4),
            jax_ops.decision_walk(jf, jflat, roots, trees, fetched, item, 1,
                                  max_contexts=4), f"item {item}")


def test_top_k_frontier_matches_the_oracle():
    idx = tc.PTreeIndex.build([
        tc.Pattern((0, 1, 2), 70),
        tc.Pattern((0, 3, 4), 21),
        tc.Pattern((0, 3, 5), 9),
    ])
    tree = idx.match_root(0)
    flat = idx.flatten()
    s, e = int(flat.tree_start[0]), int(flat.tree_start[1])
    cum = torch.as_tensor(flat.cum_prob[s + 1:e])
    depth = torch.as_tensor(flat.depth[s + 1:e])
    for k in (1, 2, 3, 5, 10):
        sel = ops.top_k_frontier(cum, depth, k=min(k, e - s - 1)).numpy()
        got = flat.items[s + 1 + sel].tolist()
        want = [n.item for n in tree.top_n_cumulative(k)]
        assert got == want, k


@pytest.mark.parametrize("seed", range(4))
def test_top_k_frontier_matches_jax_with_ties(seed):
    """Chained stable sorts against ``jnp.lexsort`` on inputs full of ties
    (probabilities in eighths and depths 1-4, exact in float32 too)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    cum = rng.integers(0, 9, size=n).astype(np.float32) / 8
    depth = rng.integers(1, 5, size=n).astype(np.int64)
    for k in sorted({1, n // 2 or 1, n}):
        got = ops.top_k_frontier(torch.as_tensor(cum), torch.as_tensor(depth),
                                 k=k).numpy()
        want = np.asarray(jax_ops.top_k_frontier(cum, depth, k=k))
        np.testing.assert_array_equal(got, want, err_msg=f"k {k}")


def engines(jidx, tidx, name, kw, max_contexts):
    """Scalar, numpy and torch engines of the port, and the reference's
    jax-backed engine."""
    jcfg, tcfg = jc.HeuristicConfig(name, **kw), tc.HeuristicConfig(name, **kw)
    return [tc.PrefetchEngine(tidx, tcfg, max_contexts),
            tc.VectorizedPrefetchEngine(tidx, tcfg, max_contexts),
            tc.VectorizedPrefetchEngine(tidx, tcfg, max_contexts,
                                        backend="torch", device="cpu"),
            jc.VectorizedPrefetchEngine(jidx, jcfg, max_contexts,
                                        backend="jax")]


def lockstep(engs, ops_, replace_at=None, replacements=None):
    for i, item in enumerate(ops_):
        if replace_at is not None and i == replace_at:
            jnew, tnew = replacements
            for e in engs[:3]:
                e.replace_index(tnew)
            engs[3].replace_index(jnew)
        out = [e.on_request(item) for e in engs]
        assert out[1:] == out[:1] * 3, (i, item, out)
        assert len({e.n_live for e in engs}) == 1, (i, item)


@pytest.mark.parametrize("name,kw", HEURISTICS, ids=[h for h, _ in HEURISTICS])
@pytest.mark.parametrize("stream", [seqb_stream, tpcc_stream],
                         ids=["seqb", "tpcc"])
def test_torch_engine_in_lockstep(name, kw, stream):
    for seed in range(2):
        jidx, tidx = indexes(seed, n_patterns=10)
        engs = engines(jidx, tidx, name, kw, 8)
        assert engs[2].device == torch.device("cpu")
        lockstep(engs, stream(seed + 3, jidx, n_ops=120))


@pytest.mark.parametrize("name,kw", HEURISTICS, ids=[h for h, _ in HEURISTICS])
@pytest.mark.parametrize("max_contexts", [1, 2, 5])
def test_torch_engine_under_eviction_pressure(name, kw, max_contexts):
    for seed in range(2):
        jidx, tidx = indexes(seed, n_patterns=10)
        lockstep(engines(jidx, tidx, name, kw, max_contexts),
                 tpcc_stream(seed + 50, jidx, n_ops=100))


@pytest.mark.parametrize("name,kw", HEURISTICS, ids=[h for h, _ in HEURISTICS])
def test_torch_engine_across_replace_index(name, kw):
    j1, t1 = indexes(11)
    j2, t2 = indexes(12)
    ops_ = seqb_stream(7, j1, n_ops=60) + seqb_stream(8, j2, n_ops=60)
    lockstep(engines(j1, t1, name, kw, 8), ops_, replace_at=60,
             replacements=(j2, t2))


def test_build_engine_passes_backend_and_device():
    _, tidx = indexes(3)
    cfg = tc.HeuristicConfig("fetch_progressive")
    eng = tc.build_engine(tidx, cfg, 4, backend="torch", device="cpu")
    assert eng.backend == "torch" and eng.device == torch.device("cpu")
    assert eng._dev_forest.items.device == torch.device("cpu")
    assert tc.build_engine(tidx, cfg).backend == "numpy"


def test_backends_and_devices_are_checked(monkeypatch):
    """Only numpy and torch; torch defaults to the card and raises
    without one."""
    _, tidx = indexes(3)
    cfg = tc.HeuristicConfig("fetch_progressive")
    with pytest.raises(ValueError, match="backend"):
        tc.VectorizedPrefetchEngine(tidx, cfg, backend="jax")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tc.VectorizedPrefetchEngine(tidx, cfg, backend="torch")
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.device_forest(tidx.flatten())
    assert tc.VectorizedPrefetchEngine(tidx, cfg).device is None
