"""Open/closed-loop load generation: millions of users on the virtual clock.

Copied unchanged from ``src/repro/serving/loadgen.py``: importing the
reference's loads JAX through ``repro/serving/__init__.py``, so the port
keeps its own copy.

The serving tentpole's traffic source.  A request is one user turn
against the cluster-resident model stack:

  prefill — one scatter-gather ``read_many`` over the user sequence's
            ``("kv", seq, block)`` KV/checkpoint shards, and
  decode  — ``decode_steps`` rounds of sequential ``(layer, expert)``
            reads along the user's prompt-domain expert-routing path
            (sticky per domain, perturbed by ``path_noise`` — exactly
            the recurrent frequent sequences VMSP mines).

Users are drawn from a Zipfian popularity law over ``n_users`` ranks
(hot users recur, the tail is effectively unbounded), each user sticks
to one prompt domain, and ``session_churn`` retires a returning user's
KV sequence for a fresh one (session churn).  Two driving modes:

  closed loop — ``streams()`` yields per-tenant session streams for
                ``ClusterClient.run`` (a fixed population of tenants,
                next request issued when the previous completes);
  open loop   — ``arrivals()`` stamps requests on the virtual clock
                with a traffic-shape-modulated Poisson process
                (``steady`` / ``diurnal`` sinusoid / ``flash`` crowd)
                and ``run_open_loop`` drives any
                :class:`repro.core.api.Client` set through them.

Everything is deterministic from ``LoadgenConfig.seed``: the same config
replays an identical arrival/session/tenant stream byte for byte (the
tier-1 contract suite pins this).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["LoadgenConfig", "LoadGenerator", "KV", "SHAPES"]

#: container namespace for KV/checkpoint shards keyed (seq, block)
KV = "kv"

#: supported traffic shapes
SHAPES = ("steady", "diurnal", "flash")


@dataclasses.dataclass
class LoadgenConfig:
    n_users: int = 1_000_000       # Zipf rank universe (hot head recurs)
    n_tenants: int = 4             # concurrent front-end clients
    n_domains: int = 8             # prompt domains w/ sticky expert paths
    zipf_s: float = 1.2            # user-popularity exponent (>1)
    n_layers: int = 6
    n_experts: int = 32
    kv_seqs: int = 256             # resident KV sequences in the store
    kv_blocks: int = 4             # (seq, block) shards read per prefill
    kv_block_bytes: int = 2048
    decode_steps: int = 4          # decode rounds per request
    path_noise: float = 0.25       # per-step off-path expert probability
    session_churn: float = 0.2     # returning user starts a fresh seq
    requests: int = 400            # total requests per generated stream
    shape: str = "steady"          # steady | diurnal | flash
    base_rate: float = 200.0       # open-loop arrivals per virtual second
    diurnal_period: float = 2.0    # virtual seconds per diurnal cycle
    flash_mult: float = 10.0       # flash-crowd rate multiplier
    flash_start: float = 0.4       # burst window, as fractions of the
    flash_end: float = 0.6         #   steady-state stream duration
    seed: int = 0
    # expert routing is a property of the *model*, not of one traffic
    # replay: paths derive from domain_seed so a warm stream (different
    # ``seed``) still exercises the same routing the measured stream will
    domain_seed: int = 0

    def __post_init__(self):
        if self.shape not in SHAPES:
            raise ValueError(f"shape must be one of {SHAPES}")


class LoadGenerator:
    """Deterministic request-stream factory for one ``LoadgenConfig``."""

    def __init__(self, cfg: LoadgenConfig):
        self.cfg = cfg
        rng = np.random.default_rng((cfg.domain_seed, 9))
        #: sticky per-domain expert-routing path — the mined sequences
        self.paths = [
            [(l, int(e)) for l, e in
             enumerate(rng.integers(0, cfg.n_experts, cfg.n_layers))]
            for _ in range(cfg.n_domains)
        ]

    # -- one request -------------------------------------------------------
    def _user(self, rng) -> int:
        """Zipf-ranked user id (0 = hottest), capped at the universe."""
        return int(min(self.cfg.n_users - 1, rng.zipf(self.cfg.zipf_s) - 1))

    def _request(self, rng, epochs: dict) -> list[list]:
        """One request = two monitored sessions: the prefill phase (one
        scatter-gather over the user's KV shards) and the decode phase
        (the expert-routing path).  Phases are separate session cuts so
        the miner sees clean recurrent expert sequences instead of
        user-unique KV prefixes subsuming them (maximal mining keeps only
        patterns no frequent supersequence contains)."""
        cfg = self.cfg
        user = self._user(rng)
        epoch = epochs.get(user, 0)
        if user in epochs and rng.random() < cfg.session_churn:
            epoch += 1                       # churn: fresh KV sequence
        epochs[user] = epoch
        seq = (user * 7919 + epoch) % cfg.kv_seqs
        domain = user % cfg.n_domains
        prefill: list = [("mr", [(KV, seq, b) for b in range(cfg.kv_blocks)])]
        decode: list = []
        path = self.paths[domain]
        for _ in range(cfg.decode_steps):
            for layer, expert in path:
                if rng.random() < cfg.path_noise:
                    expert = int(rng.integers(0, cfg.n_experts))
                decode.append(("r", (layer, expert)))
        return [prefill, decode]

    # -- closed loop -------------------------------------------------------
    def streams(self) -> list[list[list]]:
        """Per-tenant session streams for ``ClusterClient.run``.  Tenant
        t serves every ``n_tenants``-th request of one global determin-
        istic request sequence (a front-end pool behind one balancer)."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, 1))
        epochs: dict = {}
        out: list[list[list]] = [[] for _ in range(cfg.n_tenants)]
        for i in range(cfg.requests):
            out[i % cfg.n_tenants].extend(self._request(rng, epochs))
        return out

    # -- open loop ---------------------------------------------------------
    def rate(self, t: float) -> float:
        """Arrivals per virtual second at virtual time ``t``."""
        cfg = self.cfg
        if cfg.shape == "diurnal":
            phase = 2.0 * math.pi * t / cfg.diurnal_period
            return cfg.base_rate * (1.0 + 0.8 * math.sin(phase))
        if cfg.shape == "flash":
            span = cfg.requests / cfg.base_rate   # steady-state duration
            if cfg.flash_start * span <= t < cfg.flash_end * span:
                return cfg.base_rate * cfg.flash_mult
        return cfg.base_rate

    def arrivals(self) -> list[tuple[float, int, list]]:
        """Open-loop schedule: ``(t, tenant, sessions)`` stamps from a
        shape-modulated Poisson process, in arrival order; ``sessions``
        is one request's phase list (prefill, decode)."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, 2))
        epochs: dict = {}
        out = []
        t = 0.0
        for _ in range(cfg.requests):
            t += float(rng.exponential(1.0 / max(self.rate(t), 1e-9)))
            tenant = int(rng.integers(0, cfg.n_tenants))
            out.append((t, tenant, self._request(rng, epochs)))
        return out

    def run_open_loop(self, clients, arrivals=None):
        """Drive ``clients`` (anything speaking the unified ``Client``
        protocol) through an arrival schedule: each client's virtual
        clock syncs forward to the stamp, then the session's ops run
        through ``read``/``read_many``/``write``.  Returns per-client
        read latencies."""
        if arrivals is None:
            arrivals = self.arrivals()
        lats: list[list[float]] = [[] for _ in clients]
        for t, tenant, sessions in arrivals:
            c = clients[tenant]
            clock = getattr(c, "clock", None)
            if clock is not None:
                clock.sync(t)
            for ops in sessions:
                for op in ops:
                    if op[0] == "mr":
                        _, lat = c.read_many(op[1])
                        lats[tenant].append(lat)
                    elif op[0] == "w":
                        c.write(op[1], op[2])
                    else:
                        _, lat = c.read(op[1])
                        lats[tenant].append(lat)
                c.end_session()
        return lats

    # -- store contents ----------------------------------------------------
    def dataset(self) -> list[tuple[tuple, bytes]]:
        """The KV/checkpoint shard entries the cluster store must hold
        (expert weights come from :class:`ExpertStore`)."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, 3))
        return [((KV, s, b), rng.bytes(cfg.kv_block_bytes))
                for s in range(cfg.kv_seqs) for b in range(cfg.kv_blocks)]
