"""The port's load generator and expert prefetcher against the JAX
package's on the CPU.

The load generator is copied unchanged, so its streams, arrival
schedules and datasets must be byte-identical for every traffic shape.
The prefetcher's closed loop (``chip_smoke.prefetcher_loop``:
``bench_serving``'s quick configuration served by one ``ExpertPrefetcher``
a tenant) runs through both packages, the port's on ``device="cpu"``: the
latencies, mined counts, exchanged patterns and every prefetcher's
``stats`` must be equal.  ``ExpertStore`` decodes to torch tensors equal
to the numpy weights."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.core as jc  # noqa: E402
import repro.serving as js  # noqa: E402
import repro_torch.core as tc  # noqa: E402
import repro_torch.serving as ts  # noqa: E402

import chip_smoke  # noqa: E402
from benchmarks import bench_cluster, bench_overhead, bench_serving  # noqa: E402
from benchmarks.workloads import TPCC, TPCCConfig  # noqa: E402


@pytest.mark.parametrize("shape", ts.SHAPES)
@pytest.mark.parametrize("seed", range(3))
def test_loadgen_streams_are_byte_identical(shape, seed):
    kw = dict(requests=60, n_tenants=3, kv_seqs=16, shape=shape, seed=seed)
    ours = ts.LoadGenerator(ts.LoadgenConfig(**kw))
    theirs = js.LoadGenerator(js.LoadgenConfig(**kw))
    assert ours.paths == theirs.paths
    assert repr(ours.streams()) == repr(theirs.streams())
    assert repr(ours.arrivals()) == repr(theirs.arrivals())
    assert ours.dataset() == theirs.dataset()
    assert [ours.rate(t) for t in np.linspace(0, 1, 17)] == \
        [theirs.rate(t) for t in np.linspace(0, 1, 17)]
    assert (ts.KV, ts.SHAPES) == (js.KV, js.SHAPES)


@pytest.mark.parametrize("i,shape", list(enumerate(ts.SHAPES)))
def test_prefetcher_closed_loop_equals_reference(i, shape):
    ref = chip_smoke.prefetcher_loop(jc, js, shape, quick=True, seed=i)
    port = chip_smoke.prefetcher_loop(tc, ts, shape, quick=True, seed=i,
                                      device="cpu")
    for key in ("lats", "mined", "stats", "exchanged"):
        assert port[key] == ref[key], key
    assert sum(s["prefetch_hits"] for s in port["stats"]) > 0
    assert all(pf.client.device == torch.device("cpu")
               for pf in port["prefetchers"])


def test_expert_store_decodes_to_torch_tensors():
    store = ts.ExpertStore(2, 3, d=4, f=5, seed=1, device="cpu")
    ref = js.ExpertStore(2, 3, d=4, f=5, seed=1)
    for key, w in store.weights.items():
        np.testing.assert_array_equal(w, ref.weights[key])
        got = store.decode(w.tobytes())
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        assert got.dtype == torch.float32 and tuple(got.shape) == (4, 5)
        np.testing.assert_array_equal(got.numpy(), w)
        fetched = store.fetch(key)
        assert isinstance(fetched, torch.Tensor)
        np.testing.assert_array_equal(fetched.numpy(), w)
    assert store.fetches == len(store.weights)
    # other payloads (KV shards, foreign writes) pass through untouched
    assert store.decode(b"kv") == b"kv"
    assert store.decode(None) is None


def test_prefetcher_read_decodes_on_its_device():
    store = ts.ExpertStore(2, 4, d=2, f=2, seed=0, device="cpu")
    pf = ts.ExpertPrefetcher(store, device="cpu")
    value, lat = pf.read((1, 2))
    assert isinstance(value, torch.Tensor) and lat > 0
    np.testing.assert_array_equal(value.numpy(), store.weights[(1, 2)])
    values, _ = pf.read_many([(0, 0), (1, 3)])
    assert all(isinstance(v, torch.Tensor) for v in values)


def test_serving_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ts.ExpertStore(1, 2, d=2, f=2)
    store = ts.ExpertStore(1, 2, d=2, f=2, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ts.ExpertPrefetcher(store)


def test_chip_smoke_copies_match_the_benchmarks():
    """The workloads ``chip_smoke.py`` copies (it cannot import the
    benchmarks, which import the JAX package) equal the originals."""
    cfg = dict(customers_per_district=30, items=300, orders_per_district=10)
    ours, theirs = chip_smoke.TPCC(chip_smoke.TPCCConfig(**cfg)), \
        TPCC(TPCCConfig(**cfg))
    assert ours.dataset() == theirs.dataset()
    assert chip_smoke.tenant_streams(ours, 3, 40, seed=7) == \
        bench_cluster.tenant_streams(theirs, 3, 40, seed=7)
    assert dataclasses.asdict(chip_smoke.TPCCConfig()) == \
        dataclasses.asdict(TPCCConfig())
    assert repr(chip_smoke.cluster_config(jc)) == \
        repr(bench_cluster.palpatine_config())
    for quick in (True, False):
        assert chip_smoke.loadgen_config(js, "flash", quick, 2) == \
            bench_serving.loadgen_config("flash", quick, 2)
    want = bench_serving.palpatine_config(1, prefetch=True)
    got = chip_smoke.prefetcher_config(jc, js)
    assert (got.heuristic, got.preemptive_frac, got.mining,
            got.min_patterns) == (want.heuristic, want.preemptive_frac,
                                  want.mining, want.min_patterns)
    assert got.cache_experts == want.cache_bytes
    for window in (1, 4):
        a = chip_smoke.chain_forest(jc, window, window + 8).flatten()
        b = bench_overhead.chain_forest(window, window + 8).flatten()
        for field in ("items", "depth", "edge_keys", "edge_child"):
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field))
