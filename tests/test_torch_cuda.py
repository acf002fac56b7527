"""The CUDA kernels against their plain versions, on a card.

Float tolerances: f32 within 2e-5 with TF32 off (the plain version's
matmuls then run in true f32), bf16 within 2e-2 (one bf16 rounding of
the output).

Marked ``cuda``: without a card the tests skip.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from repro_torch.core import mining  # noqa: E402
from repro_torch.core.sessions import SequenceDatabase  # noqa: E402
from repro_torch.kernels.bitmap_support import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402

pytestmark = pytest.mark.cuda

#: tests/test_kernels.py's grids, then ragged tiles, several session
#: ranges and W up to 130
SSTEP_GRID = [(1, 7, 1), (5, 100, 3), (8, 512, 1), (9, 513, 2),
              (32, 1000, 4), (3, 1, 1), (70, 5000, 1), (4, 300, 70)]
FRONTIER_GRID = [(1, 1, 7, 1), (5, 9, 100, 2), (8, 8, 128, 1),
                 (9, 17, 130, 3), (16, 32, 512, 1), (3, 2, 1, 1),
                 (33, 65, 300, 2), (3, 5, 20_000, 1), (4, 33, 50, 70),
                 (40, 40, 3000, 130)]


#: chip_smoke.py's sparse grid for the frontier kernel (0, 1, 10 and 100%
#: of pairs nonzero and its edges), as tests/test_torch_bitmap_support.py
#: holds the plain version to the JAX package's oracle on it
SPARSE = chip_smoke.frontier_cases(np.random.default_rng(3))


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


#: chip_smoke.py's sparse grid for the s-step kernel: slot rows nonzero in
#: 0.4% (a median DFS node of the SEQB spill walk), 1%, 12.6% (its
#: densest node) and all of the sessions
SSTEP_SPARSE = chip_smoke.sstep_cases(np.random.default_rng(4))


@pytest.mark.parametrize("case", range(len(SSTEP_SPARSE)),
                         ids=[name for name, _, _ in SSTEP_SPARSE])
def test_sstep_kernel_equals_plain_on_sparse_slots(card, case):
    """Bit-exact where most slot words are zero, and the kernel reads a
    candidate word only beside a nonzero one."""
    _, slots, cand = SSTEP_SPARSE[case]
    slots, cand = (torch.from_numpy(x.view(np.int32)).cuda()
                   for x in (slots, cand))
    before = ops.counts["sstep_join_support"]
    joined, sup = ops.sstep_join_support(slots, cand)
    torch.cuda.synchronize()
    assert ops.counts["sstep_join_support"] == before + 1
    want_joined, want_sup = ref.sstep_join_support(slots, cand)
    assert torch.equal(joined, want_joined)
    assert torch.equal(sup, want_sup)


def test_sstep_kernel_takes_an_unaligned_row(card):
    """A slot row that starts 4 bytes into its buffer takes the one-word
    path and gives the same bits."""
    rng = np.random.default_rng(12)
    slots = words(rng, (4_001, 1)).view(-1)[1:].view(4_000, 1)
    cand = words(rng, (50, 4_000, 1))
    joined, sup = ops.sstep_join_support(slots, cand)
    torch.cuda.synchronize()
    want_joined, want_sup = ref.sstep_join_support(slots, cand)
    assert torch.equal(joined, want_joined) and torch.equal(sup, want_sup)


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


@pytest.mark.parametrize("case", range(len(SPARSE)),
                         ids=[name for name, _, _ in SPARSE])
def test_frontier_kernel_equals_plain_on_the_sparse_grid(card, case):
    """Exact, with the walk's session-major copy of cand and without it
    (the wrapper makes its own)."""
    _, slots, cand = SPARSE[case]
    slots, cand = (torch.from_numpy(x.view(np.int32)).cuda()
                   for x in (slots, cand))
    want = ref.frontier_join_support(slots, cand)
    for cand_t in (ops.session_major(cand), None):
        got = ops.frontier_join_support(slots, cand, cand_t)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


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


#: tests/test_kernels.py's (b, hq, hkv, lq, lk, d) flash grid, then
#: decode-aligned Lq < Lk, Lq > Lk (fully masked rows), GQA group 7
#: (yi-34b's 56/8) and head_dim 16; then the edges of the tensor-core
#: kernel's 128-row tiles (bf16 at D 64 and 128 takes that route):
#: ragged 1,000, Lq > Lk over a whole masked q tile, Lq < Lk = 4 x 128 + 1,
#: GQA 56/8 at D 128 over several tiles, MQA at D 64
FLASH_GRID = [(1, 2, 2, 128, 128, 64), (2, 4, 2, 128, 128, 64),
              (1, 8, 1, 256, 256, 32), (1, 2, 2, 96, 96, 64),
              (1, 4, 4, 130, 130, 128), (1, 2, 2, 8, 192, 64),
              (1, 2, 1, 100, 40, 32), (1, 14, 2, 80, 80, 16),
              (2, 56, 8, 65, 65, 128), (1, 4, 2, 1000, 1000, 128),
              (1, 4, 2, 300, 100, 128), (1, 2, 2, 200, 513, 128),
              (1, 56, 8, 300, 300, 128), (2, 8, 1, 300, 300, 64)]
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.parametrize("b,hq,hkv,lq,lk,d", FLASH_GRID)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_kernel_equals_plain(card, no_tf32, b, hq, hkv, lq, lk, d,
                                   causal, dtype):
    rng = np.random.default_rng(b * 1000 + hq * 10 + lq)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to("cuda", dtype) for s in ((b, hq, lq, d), (b, hkv, lk, d),
                                            (b, hkv, lk, d)))
    which = fa_ops.route(dtype, d)
    before = dict(fa_ops.counts)
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa_ops.counts["flash_attention"] == before["flash_attention"] + 1
    assert fa_ops.counts[which] == before[which] + 1
    want = fa_ref.flash_attention(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == want.shape
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,s,d", [(torch.float32, 70, 32),
                                       (torch.bfloat16, 300, 128)],
                         ids=["f32", "bf16"])
def test_flash_kernel_reads_strided_views(card, no_tf32, dtype, s, d):
    """The model's (B, S, H, D) activations, viewed as (B, H, S, D), on
    each route (the tensor-core kernel reads them through TMA maps)."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((2, s, 4, d)).astype(
        np.float32)).to("cuda", dtype)
    kv = torch.from_numpy(rng.standard_normal((2, s, 2, d)).astype(
        np.float32)).to("cuda", dtype)
    views = (x.transpose(1, 2), kv.transpose(1, 2), kv.transpose(1, 2))
    got = fa_ops.flash_attention(*views)
    want = fa_ref.flash_attention(*(t.contiguous() for t in views))
    torch.cuda.synchronize()
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("case", ["offset_1", "position_stride_odd",
                                  "bf16_offset_1"])
def test_tf32x3_kernel_takes_unaligned_views(card, no_tf32, case):
    """The split-TF32 kernel copies 4 bytes at a time where a base or a
    stride rules out 16: an offset view, rows 65 floats apart, a bf16
    view one element in."""
    rng = np.random.default_rng(13)
    dtype = torch.bfloat16 if case.startswith("bf16") else torch.float32
    d = 32 if dtype == torch.bfloat16 else 64
    shape = (1, 4, 100, d)
    data = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    if case == "position_stride_odd":
        q = torch.zeros((1, 4, 100, d + 1), device="cuda")[..., :d]
    else:
        q = torch.zeros(int(np.prod(shape)) + 1, dtype=dtype,
                        device="cuda")[1:].view(shape)
    q.copy_(data.to("cuda", dtype))
    k, v = (torch.from_numpy(rng.standard_normal((1, 2, 100, d)).astype(
        np.float32)).to("cuda", dtype) for _ in range(2))
    before = fa_ops.counts["tf32x3"]
    got = fa_ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa_ops.counts["tf32x3"] == before + 1
    want = fa_ref.flash_attention(q.contiguous(), k, v)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_tensor_core_grid_takes_many_heads(card):
    """B * Hq = 65,664, past a grid's y limit of 65,535, with two q tiles
    a head: the tensor-core kernel's 1-D grid holds it."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to("cuda", torch.bfloat16)
               for s in ((513, 128, 129, 64), (513, 8, 129, 64),
                         (513, 8, 129, 64)))
    before = fa_ops.counts["tensor_core"]
    got = fa_ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa_ops.counts["tensor_core"] == before + 1
    want = fa_ref.flash_attention(q, k, v)
    tol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("sm_scale", [0.3, -0.2, 0.0])
def test_tensor_core_kernel_takes_any_scale(card, sm_scale):
    """The kernel folds a positive scale into its exp2; the wrapper hands
    it the same scores for a negative or zero one."""
    rng = np.random.default_rng(10)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to("cuda", torch.bfloat16)
               for s in ((1, 4, 200, 128), (1, 2, 200, 128), (1, 2, 200, 128)))
    got = fa_ops.flash_attention(q, k, v, sm_scale=sm_scale)
    torch.cuda.synchronize()
    want = fa_ref.flash_attention(q, k, v, sm_scale=sm_scale)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


def test_tensor_core_route_rejects_a_misaligned_base(card):
    """A TMA map needs a 16-byte-aligned base: a view one element into a
    buffer is refused before any launch."""
    q = torch.zeros(1 + 2 * 128 * 64, dtype=torch.bfloat16,
                    device="cuda")[1:].view(1, 2, 128, 64)
    k = torch.zeros((1, 2, 128, 64), dtype=torch.bfloat16, device="cuda")
    before = dict(fa_ops.counts)
    with pytest.raises(ValueError, match="aligned"):
        fa_ops.flash_attention(q, k, k)
    assert fa_ops.counts == before


def test_serving_on_the_card_runs_the_kernel(card, no_tf32):
    """Reduced codeqwen, f32: the card's greedy tokens equal the CPU's,
    and each prefill launches the kernel once per layer."""
    from repro_torch import configs
    from repro_torch.models import init_params
    from repro_torch.serving import ServeConfig, ServingEngine

    cfg = configs.reduced(configs.get_config("codeqwen1.5-7b"),
                          attention_impl="pallas")
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    on_cpu = ServingEngine(cfg, model, ServeConfig(max_len=32),
                           device="cpu").generate(prompts, 8)
    before = dict(fa_ops.counts), dict(fa_ref.counts)
    on_card = ServingEngine(cfg, model.cuda(), ServeConfig(max_len=32),
                            device="cuda").generate(prompts, 8)
    np.testing.assert_array_equal(on_card, on_cpu)
    assert fa_ops.counts["flash_attention"] == (
        before[0]["flash_attention"] + cfg.n_layers)
    assert fa_ops.counts["tf32x3"] == before[0]["tf32x3"] + cfg.n_layers
    assert fa_ref.counts == before[1]


def test_bf16_serving_launches_only_the_tensor_core_kernel(card):
    """Reduced codeqwen in bf16 at head_dim 128: every prefill layer takes
    the tensor-core route, none the split-TF32 one or the plain version."""
    from repro_torch import configs
    from repro_torch.models import init_params
    from repro_torch.serving import ServeConfig, ServingEngine

    cfg = configs.reduced(configs.get_config("codeqwen1.5-7b"),
                          attention_impl="pallas", head_dim=128,
                          dtype="bfloat16")
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 200)).astype(np.int32)
    before = dict(fa_ops.counts), dict(fa_ref.counts)
    out = ServingEngine(cfg, model, ServeConfig(max_len=208),
                        device="cuda").generate(prompts, 8)
    assert out.shape == (2, 8)
    assert {r: fa_ops.counts[r] - before[0][r] for r in fa_ops.counts} == {
        "flash_attention": cfg.n_layers, "tensor_core": cfg.n_layers,
        "tf32x3": 0}
    assert fa_ref.counts == before[1]


#: head_dims of the split-TF32 kernel beyond 16/32/64/128: its new
#: instantiations (48, 80, 96, 112: zamba2-7b's) and head_dims it reaches
#: by zero padding (1, 40, 57, 72, 100, 113, 127)
ANY_D = [1, 40, 48, 57, 72, 80, 96, 100, 112, 113, 127]


@pytest.mark.parametrize("d", ANY_D)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_tf32x3_kernel_takes_any_head_dim(card, no_tf32, d, causal, dtype):
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to("cuda", dtype) for s in ((2, 4, 90, d), (2, 2, 130, d),
                                            (2, 2, 130, d)))
    assert fa_ops.route(dtype, d) == "tf32x3"
    before = fa_ops.counts["tf32x3"]
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa_ops.counts["tf32x3"] == before + 1
    want = fa_ref.flash_attention(q, k, v, causal=causal)
    assert got.shape == want.shape and got.dtype == dtype
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_smallest_head_dim_112_input_on_the_card(card, no_tf32):
    q, k, v = (torch.from_numpy(np.random.default_rng(112).standard_normal(
        (1, 1, 1, 112)).astype(np.float32)).cuda() for _ in range(3))
    torch.testing.assert_close(fa_ops.flash_attention(q, k, v),
                               fa_ref.flash_attention(q, k, v),
                               rtol=2e-5, atol=2e-5)


def test_head_dim_past_the_kernels_raises_on_the_card(card):
    q = torch.zeros((1, 2, 8, 144), device="cuda")
    before = dict(fa_ops.counts)
    with pytest.raises(ValueError, match="head_dim"):
        fa_ops.flash_attention(q, q, q)
    assert fa_ops.counts == before


def test_torch_decision_engine_on_the_card_equals_numpy(card):
    """The ``"torch"`` backend walking on the card, in lockstep with the
    numpy engine over the chain forest and a noisy stream."""
    from repro_torch import core

    index = chip_smoke.chain_forest(core, 16, 80)
    rng = np.random.default_rng(0)
    stream = [int(x) for x in rng.integers(-2, 100, size=200)] + \
        list(range(80))
    for name in ("fetch_all", "fetch_top_n", "fetch_progressive"):
        cfg = core.HeuristicConfig(name, top_n=3, progressive_depth=3)
        a = core.VectorizedPrefetchEngine(index, cfg, 32)
        b = core.VectorizedPrefetchEngine(index, cfg, 32, backend="torch")
        assert b._dev_forest.items.device.type == "cuda"
        for item in stream:
            assert a.on_request(item) == b.on_request(item), (name, item)
            assert a.n_live == b.n_live


def test_cluster_tenants_mine_on_the_card_as_on_the_cpu(card):
    """Two tenants over 4 shards, 60 transactions a stage: the card's
    mines launch the frontier kernel and give the CPU's run."""
    from repro_torch import core

    gen = chip_smoke.TPCC(chip_smoke.TPCCConfig())

    def run(device):
        store = core.ShardedDKVStore(4)
        store.load(gen.dataset())
        cluster = core.ClusterClient(store, core.ClusterConfig(
            n_clients=2, palpatine=chip_smoke.cluster_config(core)),
            device=device)
        cluster.run(chip_smoke.tenant_streams(gen, 2, 60, seed=3))
        before = dict(ops.counts), dict(ref.counts)
        cluster.mine_all()
        launched = (ops.counts["frontier_join_support"]
                    - before[0]["frontier_join_support"])
        plain = {n: ref.counts[n] - before[1][n] for n in ref.counts}
        cluster.exchange_patterns()
        cluster.reset_stats()
        lats = cluster.run(chip_smoke.tenant_streams(gen, 2, 60, seed=7))
        return (lats, cluster.aggregate_stats(),
                [(p.items, p.support) for p in cluster.exchange.col_store],
                launched, plain)

    card_run, cpu_run = run("cuda"), run("cpu")
    assert card_run[3] > 0 and not any(card_run[4].values())
    assert card_run[:3] == cpu_run[:3]


def test_expert_prefetcher_on_the_card_as_on_the_cpu(card):
    from repro_torch import core, serving

    on_card = chip_smoke.prefetcher_loop(core, serving, "steady", True, 0,
                                         device="cuda")
    value, _ = on_card["prefetchers"][0].read((0, 0))
    assert isinstance(value, torch.Tensor) and value.device.type == "cuda"
    on_cpu = chip_smoke.prefetcher_loop(core, serving, "steady", True, 0,
                                        device="cpu")
    for key in ("lats", "mined", "stats", "exchanged"):
        assert on_card[key] == on_cpu[key], key
