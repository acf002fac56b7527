"""The port's Palpatine client in lockstep with the JAX package's.

Both clients get their own store, loaded with the same data and a latency
model of the same seed, and see the same operations in the same order:
every (value, latency), the mined metastore (in order) and the cache
statistics must be equal.  The port runs on ``device="cpu"``."""

import dataclasses
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.core as jc  # noqa: E402
import repro_torch.core as tc  # noqa: E402
from benchmarks.workloads import SEQB, TPCC, SEQBConfig, TPCCConfig  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def make_config(pkg, **kw):
    base = dict(
        heuristic=pkg.HeuristicConfig("fetch_progressive", top_n=5),
        cache_bytes=16 << 10,
        mining=pkg.MiningParams(minsup=0.02, min_len=3, max_len=15,
                                maxgap=1),
        algo="vmsp",
        min_patterns=20,
        dynamic_minsup_floor=0.01,
    )
    base.update(kw)
    return pkg.PalpatineConfig(**base)


def make_store(pkg, dataset, seed):
    store = pkg.SimulatedDKVStore(pkg.LatencyModel(seed=seed))
    store.load(dataset)
    return store


def apply(client, op):
    if isinstance(op, tuple) and len(op) == 2 and op[0] in ("r", "w"):
        kind, key = op
        if kind == "w":
            return (None, client.write(key, b"x" * 64))
        return client.read(key)
    return client.read(op)


def lockstep(dataset, stage1, stage2, **cfg):
    """Drive both clients through two stages; returns them."""
    clients = [pkg.PalpatineClient(make_store(pkg, dataset, seed=11),
                                   make_config(pkg, **cfg), **dev)
               for pkg, dev in ((jc, {}), (tc, {"device": "cpu"}))]
    for i, stage in enumerate((stage1, stage2)):
        for sess in stage:
            for op in sess:
                got = [apply(c, op) for c in clients]
                assert got[1] == got[0], op
            for c in clients:
                c.end_session()
        if i == 0:
            n = [c.mine_now() for c in clients]
            assert n[1] == n[0] and n[0] > 0
            for c in clients:
                c.cache.stats = type(c.cache.stats)()
    ref, port = clients
    assert [(p.items, p.support) for p in port.metastore.patterns] == \
        [(p.items, p.support) for p in ref.metastore.patterns]
    assert dataclasses.asdict(port.stats) == dataclasses.asdict(ref.stats)
    assert port.clock.now == ref.clock.now
    return ref, port


def test_seqb_two_stage_lockstep():
    seqb = SEQB(SEQBConfig(n_blocks=3_000, n_frequent=40, seed=3))
    ref, port = lockstep(
        list(seqb.dataset()),
        list(seqb.sessions(np.random.default_rng(1), 300)),
        list(seqb.sessions(np.random.default_rng(2), 150)))
    assert port.stats.prefetch_hits > 0
    assert port.cache.attr.total_hits == ref.cache.attr.total_hits


def test_tpcc_column_mining_lockstep():
    gen = TPCC(TPCCConfig(customers_per_district=30, items=300,
                          orders_per_district=10))
    stage1 = [gen.transaction(np.random.default_rng(s)) for s in range(150)]
    stage2 = [gen.transaction(np.random.default_rng(1000 + s))
              for s in range(80)]
    ref, port = lockstep(gen.dataset(), stage1, stage2, column_mining=True)
    assert ref.col_metastore is not None and len(ref.col_metastore) > 0
    assert [(p.items, p.support) for p in port.col_metastore.patterns] == \
        [(p.items, p.support) for p in ref.col_metastore.patterns]


def test_client_satisfies_its_protocol():
    store = make_store(tc, [(("t", "r0", "c"), b"v")], seed=0)
    client = tc.PalpatineClient(store, device="cpu")
    assert isinstance(client, tc.Client)
    assert client.device == torch.device("cpu")


def test_construction_without_cuda_raises(monkeypatch):
    """The default device is the card; no card means an error, never a
    silent CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = make_store(tc, [(("t", "r0", "c"), b"v")], seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tc.PalpatineClient(store)
    with pytest.raises(RuntimeError, match="CUDA"):
        tc.PalpatineClient(store, device="cuda")


def test_chip_smoke_seqb_copy_matches_benchmark_stream(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, "chip_smoke", smoke)
    spec.loader.exec_module(smoke)
    cfg = dict(n_blocks=5_000, n_frequent=64, seed=7)
    ours = smoke.SEQB(smoke.SEQBConfig(**cfg))
    theirs = SEQB(SEQBConfig(**cfg))
    assert ours.sequences == theirs.sequences
    np.testing.assert_array_equal(ours.seq_probs, theirs.seq_probs)
    assert list(ours.sessions(np.random.default_rng(5), 200)) == \
        list(theirs.sessions(np.random.default_rng(5), 200))
    assert list(ours.dataset())[:10] == list(theirs.dataset())[:10]
