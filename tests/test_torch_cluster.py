"""The port's sharded cluster against the JAX package's on the CPU.

The sweeps of ``benchmarks/bench_cluster.py`` at its quick settings run
through both packages on the same TPC-C streams (each package's tenants configured by
``chip_smoke.cluster_config``, ``bench_cluster.palpatine_config``'s
copy): the port's tenants mine
on ``device="cpu"``.  Everything runs on the simulation's virtual clock,
so the per-tenant latency lists, ``aggregate_stats``, ``per_shard_stats``,
``aggregate_attribution`` and the exchanged patterns must be equal, and so
must every membership, detection and drain report.  Seeded chaos
schedules must leave byte-identical replicas in both packages."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.core as jc  # noqa: E402
import repro_torch.core as tc  # noqa: E402
from benchmarks.bench_cluster import tenant_streams  # noqa: E402
from benchmarks.workloads import TPCC, TPCCConfig  # noqa: E402
from tools import chaoscheck  # noqa: E402

import chip_smoke  # noqa: E402

PKGS = ((jc, {}), (tc, {"device": "cpu"}))
GEN = TPCC(TPCCConfig())


def degraded_latencies(pkg, n_shards, slow_node=0, factor=10.0,
                       jitter=0.1):
    """``bench_cluster.degraded_latencies`` in ``pkg``."""
    out = []
    for i in range(n_shards):
        slow = i == slow_node and factor > 1.0
        mult = factor if slow else 1.0
        out.append(pkg.LatencyModel(seed=1009 + i,
                                    jitter_sigma=0.4 if slow else jitter,
                                    stall_frac=0.05 if slow else 0.0,
                                    stall_mult=10.0,
                                    rtt=500e-6 * mult,
                                    per_item_service=150e-6 * mult))
    return out


def store_of(pkg, n_shards, **kw):
    store = pkg.ShardedDKVStore(n_shards, **kw)
    store.load(GEN.dataset())
    return store


def cluster_of(pkg, dev, store, n_clients, **kw):
    return pkg.ClusterClient(store, pkg.ClusterConfig(
        n_clients=n_clients, palpatine=chip_smoke.cluster_config(pkg), **kw),
        **dev)


def outcome(cluster, lats) -> dict:
    """Everything a run shows: latencies, statistics, attribution and the
    exchanged patterns (in the exchange's order)."""
    attr = cluster.aggregate_attribution()
    return {
        "lats": lats,
        "agg": dataclasses.asdict(cluster.aggregate_stats()),
        "per_shard": [dataclasses.asdict(s)
                      for s in cluster.per_shard_stats()],
        "attr": {k: dataclasses.asdict(r) for k, r in attr.rows.items()},
        "patterns": [(p.items, p.support) for p in cluster.exchange.store],
        "col_patterns": [(p.items, p.support)
                         for p in cluster.exchange.col_store],
        "clocks": [t.clock.now for t in cluster.tenants],
    }


def warm(cluster, n_clients, n_tx, seed):
    """Stage 1, mine, exchange: the sweeps' common prologue."""
    cluster.run(tenant_streams(GEN, n_clients, n_tx, seed=seed))
    cluster.mine_all()
    cluster.exchange_patterns()


def window(cluster, n_clients, n_tx, seed) -> dict:
    cluster.reset_stats()
    return outcome(cluster, cluster.run(
        tenant_streams(GEN, n_clients, n_tx, seed=seed)))


def both(run) -> list:
    """``run(pkg, dev)`` in the reference, then in the port."""
    return [run(pkg, dev) for pkg, dev in PKGS]


def assert_equal_runs(got, want):
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], key


@pytest.mark.parametrize("n_shards", [1, 4])
def test_static_sweep_equals_reference(n_shards):
    """``static_sweep(quick=True)``: S shards, 2 tenants, 60 transactions a
    tenant a stage, beside the baseline."""
    n_clients, n_tx = 2, 60
    stage2 = tenant_streams(GEN, n_clients, n_tx, seed=7)

    def run(pkg, dev):
        base = pkg.ClusterBaseline(store_of(pkg, n_shards), n_clients)
        base_lats = base.run(stage2)
        cluster = cluster_of(pkg, dev, store_of(pkg, n_shards), n_clients)
        warm(cluster, n_clients, n_tx, seed=3)
        cluster.reset_stats()
        out = outcome(cluster, cluster.run(stage2))
        out["baseline"] = base_lats
        return out

    ref, port = both(run)
    assert_equal_runs(port, ref)
    assert port["agg"]["prefetch_hits"] > 0 and port["col_patterns"]


def test_degraded_replica_run_equals_reference():
    """``degraded_sweep``: one 10x-slow replica at R=2, 2 shards, 4
    tenants."""
    n_clients, n_tx = 4, 60

    def run(pkg, dev):
        store = pkg.ShardedDKVStore(2, latencies=degraded_latencies(pkg, 2),
                                    replication=2)
        store.load(GEN.dataset())
        cluster = cluster_of(pkg, dev, store, n_clients)
        warm(cluster, n_clients, n_tx, seed=11)
        return window(cluster, n_clients, n_tx, seed=13)

    ref, port = both(run)
    assert_equal_runs(port, ref)


def test_elastic_add_node_mid_run_equals_reference():
    """``elastic_sweep``: a third node joins between two windows; the
    move report and every window match."""
    n_clients, n_tx = 3, 50

    def run(pkg, dev):
        store = pkg.ShardedDKVStore(
            2, latencies=degraded_latencies(pkg, 2, factor=1.0),
            replication=2)
        store.load(GEN.dataset())
        cluster = cluster_of(pkg, dev, store, n_clients,
                             rebalance_every_ops=500)
        warm(cluster, n_clients, n_tx, seed=21)
        out = {"steady": window(cluster, n_clients, n_tx, seed=23)}
        report = store.add_node(
            latency=pkg.LatencyModel(seed=1011, jitter_sigma=0.1,
                                     stall_frac=0.0),
            now=store.frontier())
        out["report"] = dict(dataclasses.asdict(report),
                             placement_fraction=report.placement_fraction)
        out["post_scale"] = window(cluster, n_clients, n_tx, seed=25)
        out["recovered"] = window(cluster, n_clients, n_tx, seed=27)
        return out

    ref, port = both(run)
    assert_equal_runs(port, ref)
    assert port["report"]["placement_fraction"] > 0


def test_detection_run_equals_reference():
    """``detection_sweep``: a node crashes with no ``set_down``; suspicion
    emerges from traffic, quorum writes go to sloppy successors, and
    recovery clears the verdict and converges the replicas."""
    n_clients, n_tx = 3, 60

    def run(pkg, dev):
        store = pkg.ShardedDKVStore(
            3, latencies=degraded_latencies(pkg, 3, factor=1.0),
            replication=2, write_mode="quorum", failure_detection=True,
            sloppy_quorum=True)
        store.load(GEN.dataset())
        cluster = cluster_of(pkg, dev, store, n_clients,
                             rebalance_every_ops=500)
        warm(cluster, n_clients, n_tx, seed=31)
        out = {"steady": window(cluster, n_clients, n_tx, seed=33)}
        store.shards[1].crash()
        out["crashed"] = window(cluster, n_clients, n_tx, seed=35)
        out["suspected"] = store.detector.suspected(1)
        store.shards[1].recover()
        out["recovered"] = window(cluster, n_clients, n_tx, seed=37)
        out["cleared"] = not store.detector.suspected(1)
        out["counters"] = (store.rpc_timeouts, store.sloppy_writes,
                           store.probes, store.stale_reads,
                           store.hints.replayed)
        out["replicas"] = chaoscheck.fingerprint(store)
        return out

    ref, port = both(run)
    assert_equal_runs(port, ref)
    assert port["suspected"] and port["cleared"]


def test_drain_equals_reference():
    """``drain_sweep``: a live node drained under read load serves no
    stale read, and streams what the reference streams."""
    def run(pkg, dev):
        store = pkg.ShardedDKVStore(
            4, latencies=degraded_latencies(pkg, 4, factor=1.0),
            replication=2, write_mode="quorum", read_quorum=2,
            failure_detection=True)
        data = GEN.dataset()
        t = 0.0
        for k, v in data:
            t += 2e-5
            store.put(k, v, t)
        hot = [k for k, _ in data[::31]]
        reads = []

        def on_batch(tb):
            for k in hot:
                reads.append(store.get_async(k, tb).values[0])

        report = store.drain_node(3, now=store.frontier(), on_batch=on_batch)
        return {"report": dataclasses.asdict(report), "reads": reads,
                "replicas": chaoscheck.fingerprint(store)}

    ref, port = both(run)
    assert_equal_runs(port, ref)
    assert port["report"]["stale_reads_during"] == 0


def chaos_run(seed: int) -> dict:
    """``tools.chaoscheck.run_schedule(seed, quick=True)`` on the port's
    classes: two coordinators writing through the seeded fault windows,
    then healed past the horizon."""
    horizon = 0.25
    store = tc.ShardedDKVStore(
        n_shards=4, replication=2, read_quorum=1, write_mode="quorum",
        failure_detection=True, sloppy_quorum=True, versioning="dotted",
        record_acks=True, strict_read_quorum=False)
    peer = store.attach_coordinator()
    store.enable_chaos(tc.ChaosEngine(tc.ChaosSchedule.random(
        seed, nodes=range(store.n_shards), coords=("c0", "c1"),
        horizon=horizon)))
    exchange = tc.VerdictExchange()
    coords = [store, peer]
    unavailable = reads_failed = 0
    n_ops = 400
    for i in range(n_ops):
        now = (i + 1) * (horizon * 1.2 / n_ops)
        c = coords[i % 2]
        try:
            c.put(f"k{i % chaoscheck.N_KEYS}",
                  chaoscheck.VALUE + str(i).encode(), now)
        except KeyError:
            unavailable += 1
        if i % 3 == 2:
            try:
                c.get_async(f"k{(i - 2) % chaoscheck.N_KEYS}", now)
            except KeyError:
                reads_failed += 1
        if i % 16 == 15:
            exchange.gossip(coords, now)
    t = horizon * 2.0
    heal = tc.VerdictExchange()
    for _ in range(6):
        t += chaoscheck.OP_DT
        store.reconcile(t)
        peer.reconcile(t)
        heal.gossip(coords, t)
        if len(store.hints) == 0 and len(peer.hints) == 0:
            break
    lost = [(k, v) for c in coords for k, v, _ in c.acked_writes
            if not any(tc.descends(store.shards[s].versions.get(k, 0), v)
                       for s in store.replicas_of(k)
                       if k in store.shards[s].data)]
    return {"fingerprint": chaoscheck.fingerprint(store),
            "errors": (chaoscheck.check_convergence(store)
                       + chaoscheck.check_hint_conservation(store, peer)),
            "lost": lost, "unavailable_writes": unavailable,
            "unavailable_reads": reads_failed,
            "siblings_detected": store.siblings_detected
            + peer.siblings_detected,
            "sibling_merges": store.sibling_merges + peer.sibling_merges}


@pytest.mark.parametrize("seed", range(5))
def test_chaos_schedule_leaves_the_reference_replicas(seed):
    want = chaoscheck.run_schedule(seed, quick=True)
    got = chaos_run(seed)
    assert got["fingerprint"] == want["fingerprint"]
    assert got["errors"] == [] and got["lost"] == []
    for key in ("unavailable_writes", "unavailable_reads",
                "siblings_detected", "sibling_merges"):
        assert got[key] == want[key], key


def test_cluster_client_defaults_to_the_card(monkeypatch):
    """Tenants are built on the device from the start; with no card and
    no device the cluster raises, and the baseline needs no device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = store_of(tc, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tc.ClusterClient(store, tc.ClusterConfig(n_clients=1))
    assert len(tc.ClusterBaseline(store, 2).tenants) == 2
    cluster = tc.ClusterClient(store, tc.ClusterConfig(n_clients=2),
                               device="cpu")
    assert {t.device for t in cluster.tenants} == {torch.device("cpu")}
