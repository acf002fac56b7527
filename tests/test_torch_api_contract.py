"""The port's copy of the unified-client contract suite
(``tests/test_api_contract.py``), on ``device="cpu"``.

Every serving/cluster entry point speaks :class:`repro_torch.core.api.Client`:
``PalpatineClient`` over the simulated single-node store, a
``ClusterClient`` tenant over the sharded store, and the serving stack's
``ExpertPrefetcher`` over a cluster-resident ``ExpertStore``.  The suite
drives all three through one workload shape and pins the shared
semantics: read round-trips, session-cut -> mining, prefetch-attribution
conservation, the deprecation shims, and the load generator's
byte-identical determinism.  The prefetcher's values decode to torch
tensors on the device it was given.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (  # noqa: E402
    Client,
    ClusterClient,
    ClusterConfig,
    HeuristicConfig,
    MiningParams,
    PalpatineClient,
    PalpatineConfig,
    ShardedDKVStore,
    SimulatedDKVStore,
)
from repro_torch.serving import (  # noqa: E402
    ExpertPrefetcher,
    ExpertStore,
    LoadGenerator,
    LoadgenConfig,
    PrefetcherConfig,
)

N_LAYERS, N_EXPERTS = 3, 8


def _pconfig() -> PalpatineConfig:
    # 8 x 64-byte slots — far below the 24-item keyspace, so misses occur
    # and the prefetch pipeline has real work on every surface
    return PalpatineConfig(
        heuristic=HeuristicConfig("fetch_progressive"),
        cache_bytes=512,
        preemptive_frac=0.5,
        mining=MiningParams(minsup=0.05, min_len=3, max_len=10, maxgap=1),
        min_patterns=8,
        dynamic_minsup_floor=0.05,
    )


def make_palpatine():
    """PalpatineClient over the single-node simulated store."""
    store = SimulatedDKVStore()
    store.load(((l, e), bytes(64))
               for l in range(N_LAYERS) for e in range(N_EXPERTS))
    client = PalpatineClient(store, _pconfig(), device="cpu")
    return client, lambda v: v


def make_cluster_tenant():
    """A ClusterClient tenant over the sharded store (per-shard caches,
    gossiped metastore) — the same protocol surface as a bare client."""
    store = ShardedDKVStore(2)
    store.load(((l, e), bytes(64))
               for l in range(N_LAYERS) for e in range(N_EXPERTS))
    cluster = ClusterClient(store, ClusterConfig(
        n_clients=1, palpatine=_pconfig()), device="cpu")
    return cluster.tenants[0], lambda v: v


def make_prefetcher():
    """ExpertPrefetcher over a cluster-resident ExpertStore; values decode
    to torch tensors, so comparisons go through tobytes()."""
    store = ExpertStore(N_LAYERS, N_EXPERTS, d=4, f=4, seed=3, device="cpu")
    pf = ExpertPrefetcher(store, PrefetcherConfig(
        cache_experts=8,
        mining=MiningParams(minsup=0.05, min_len=3, max_len=10, maxgap=1)),
        device="cpu")

    def norm(v):
        assert isinstance(v, torch.Tensor) and v.device.type == "cpu"
        return v.numpy().tobytes()

    return pf, norm


SURFACES = [make_palpatine, make_cluster_tenant, make_prefetcher]
SURFACE_IDS = ["palpatine", "cluster-tenant", "expert-prefetcher"]


def expected_value(factory, client, container):
    """Ground truth bytes for a container on each surface."""
    if factory is make_prefetcher:
        return client.store.weights[container].tobytes()
    return bytes(64)


def drive_sessions(client, n_sessions, path=None):
    """Repeated recurrent sessions (the paper's regime): a fixed expert
    path plus one rotating distractor read."""
    path = path or [(l, l % N_EXPERTS) for l in range(N_LAYERS)]
    for s in range(n_sessions):
        for key in path:
            client.read(key)
        client.read((0, (s % (N_EXPERTS - 1)) + 1))
        client.end_session()


@pytest.mark.parametrize("factory", SURFACES, ids=SURFACE_IDS)
def test_surface_is_a_client(factory):
    client, _ = factory()
    assert isinstance(client, Client)


@pytest.mark.parametrize("factory", SURFACES, ids=SURFACE_IDS)
def test_read_round_trip(factory):
    client, norm = factory()
    value, latency = client.read((1, 2))
    assert norm(value) == expected_value(factory, client, (1, 2))
    assert latency > 0.0


@pytest.mark.parametrize("factory", SURFACES, ids=SURFACE_IDS)
def test_read_many_orders_and_overlaps(factory):
    client, norm = factory()
    keys = [(l, e) for l in range(N_LAYERS) for e in (0, 1)]
    values, batch_latency = client.read_many(keys)
    assert len(values) == len(keys)
    for key, value in zip(keys, values):
        assert norm(value) == expected_value(factory, client, key)
    # scatter-gather: the batch completes at the slowest fetch, not at
    # the sum of sequential round trips
    _, single = client.read((2, 7))
    assert batch_latency < len(keys) * single * 2


@pytest.mark.parametrize("factory", SURFACES, ids=SURFACE_IDS)
def test_write_read_coherence(factory):
    client, norm = factory()
    if factory is make_prefetcher:
        new = np.full((4, 4), 7.0, dtype=np.float32)
        client.write((0, 0), new)
        value, _ = client.read((0, 0))
        assert norm(value) == new.tobytes()
    else:
        client.write((0, 0), b"x" * 64)
        value, _ = client.read((0, 0))
        assert norm(value) == b"x" * 64


@pytest.mark.parametrize("factory", SURFACES, ids=SURFACE_IDS)
def test_session_cut_feeds_mining(factory):
    """end_session is the session boundary: repeated sessions make the
    path minable (support >= 2), and mine_now reports stored patterns."""
    client, _ = factory()
    drive_sessions(client, 12)
    assert client.mine_now() > 0


@pytest.mark.parametrize("factory", SURFACES, ids=SURFACE_IDS)
def test_prefetch_attribution_conservation(factory):
    """Every prefetch hit is attributed to some pattern row (unattributed
    causes land in the sentinel row, so the table's total always matches
    the cache counter exactly)."""
    client, _ = factory()
    drive_sessions(client, 12)
    client.mine_now()
    drive_sessions(client, 12)
    cache = client.cache
    assert cache.stats.prefetches > 0
    assert cache.attr.total_hits == cache.stats.prefetch_hits


@pytest.mark.parametrize("factory", SURFACES, ids=SURFACE_IDS)
def test_stats_surface(factory):
    client, _ = factory()
    drive_sessions(client, 4)
    stats = client.stats
    # dict view (prefetcher) or CacheStats (core clients) — both expose
    # the hit-rate headline
    hr = stats["hit_rate"] if isinstance(stats, dict) else stats.hit_rate
    assert 0.0 <= hr <= 1.0


def test_prefetcher_access_shim_matches_read():
    pf, _ = make_prefetcher()
    via_shim = pf.access(1, 3)
    via_read, _ = pf.read((1, 3))
    np.testing.assert_allclose(via_shim.numpy(), via_read.numpy())
    np.testing.assert_allclose(via_read.numpy(), pf.store.weights[(1, 3)])


def test_prefetcher_counts_sessions_and_ops():
    pf, _ = make_prefetcher()
    drive_sessions(pf, 5)
    s = pf.stats
    assert s["sessions"] == 5
    assert s["ops"] == 5 * (N_LAYERS + 1)
    assert s["read_latency"]["count"] == 5 * (N_LAYERS + 1)


# ---------------------------------------------------------------- loadgen


def _lg(seed=0, **kw) -> LoadgenConfig:
    kw.setdefault("requests", 40)
    kw.setdefault("n_tenants", 2)
    kw.setdefault("kv_seqs", 16)
    return LoadgenConfig(seed=seed, **kw)


def test_loadgen_deterministic_streams():
    a, b = LoadGenerator(_lg()), LoadGenerator(_lg())
    assert repr(a.streams()) == repr(b.streams())
    assert repr(a.arrivals()) == repr(b.arrivals())
    assert a.dataset() == b.dataset()


def test_loadgen_seed_changes_stream():
    a, b = LoadGenerator(_lg(seed=0)), LoadGenerator(_lg(seed=1))
    assert repr(a.streams()) != repr(b.streams())
    # the routing paths are the model's, not the replay's: same domains
    assert a.paths == b.paths


def test_loadgen_shapes():
    with pytest.raises(ValueError):
        LoadgenConfig(shape="sawtooth")
    steady = LoadGenerator(_lg(shape="steady"))
    flash = LoadGenerator(_lg(shape="flash"))
    assert steady.rate(0.0) == steady.rate(1e9)
    span = flash.cfg.requests / flash.cfg.base_rate
    assert flash.rate(span * 0.5) > flash.rate(0.0)


def test_loadgen_open_loop_drives_protocol_clients():
    gen = LoadGenerator(_lg())
    store = ShardedDKVStore(2)
    store.load(gen.dataset())
    ExpertStore(gen.cfg.n_layers, gen.cfg.n_experts, d=2, f=2, dkv=store,
                device="cpu")
    cluster = ClusterClient(store, ClusterConfig(
        n_clients=gen.cfg.n_tenants, palpatine=_pconfig()), device="cpu")
    lats = gen.run_open_loop(cluster.tenants)
    assert sum(len(ls) for ls in lats) > 0
    # arrivals stamp the virtual clock: tenants moved forward to (at
    # least) their last arrival
    last = {}
    for t, tenant, _ in gen.arrivals():
        last[tenant] = t
    for i, tenant in enumerate(cluster.tenants):
        if i in last:
            assert tenant.clock.now >= last[i]
