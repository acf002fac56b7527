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
#: kernel's 128-row tiles (bf16 up to D 128 takes that route):
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
    stride rules out 16: an offset view, rows 65 floats apart; a bf16
    view one element in at head_dim 144 goes to the tensor-core kernel's
    wide kernel as an aligned copy (bf16 took split TF32 past 128 before
    that kernel)."""
    rng = np.random.default_rng(13)
    dtype = torch.bfloat16 if case.startswith("bf16") else torch.float32
    d = 144 if dtype == torch.bfloat16 else 64
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
    which = "tensor_core" if dtype == torch.bfloat16 else "tf32x3"
    assert fa_ops.route(dtype, d) == which
    before = fa_ops.counts[which]
    got = fa_ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa_ops.counts[which] == before + 1
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


@pytest.mark.parametrize("d", [64, 128, 192, 256])
def test_tensor_core_kernel_rounds_only_its_output(card, no_tf32, d):
    """The tensor cores take p in bf16: the kernel splits f32 p into
    three bf16 parts (all of its 24 bits) and sums each kv tile's P.V from
    zero before adding it to O in f32, so its output is as far from the
    exact (f64) attention of the bf16 inputs as the plain version's single
    bf16 rounding, on average (the f32 attention stands for the exact one:
    its error is far below bf16's); at 192 and 256 on the wide kernel of
    one warpgroup too.  p rounded once to bf16 drifted a 32-layer model's
    logits past bf16's floor."""
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to("cuda", torch.bfloat16)
               for s in ((1, 8, 1024, d), (1, 2, 1024, d), (1, 2, 1024, d)))
    exact = fa_ref.flash_attention(q.float(), k.float(), v.float()).double()
    got = fa_ops.flash_attention(q, k, v)
    assert fa_ops.route(q.dtype, d) == "tensor_core"
    plain = fa_ref.flash_attention(q, k, v)
    err = float((got.double() - exact).abs().mean())
    floor = float((plain.double() - exact).abs().mean())
    assert err <= 1.1 * floor, (err, floor)


@pytest.mark.parametrize("d", [192, 256])
def test_wide_kernel_rounds_as_often_as_the_d128_kernel(card, no_tf32, d):
    """Up to head_dim 256 the wide kernel's one warpgroup sums each kv
    tile's P.V from zero and adds it to O in f32, as the D 128 kernel
    does: at the serving prefill shape (B 4, H 32, L 2,048, causal, the
    model's layout) the share of its bf16 outputs that round unlike the
    plain version's is within 1.25x of the D 128 kernel's, as phase 8 of
    chip_smoke.py holds it.  With P.V chained into O across the tiles the
    share was 3.6x (PERF.md, Findings); the mean error of
    ``test_tensor_core_kernel_rounds_only_its_output`` does not see that."""
    shares = {}
    for dd in (128, d):
        rng = np.random.default_rng(1)
        q, k, v = (torch.from_numpy(rng.standard_normal((4, 2048, 32, dd))
                                    .astype(np.float32))
                   .to("cuda", torch.bfloat16).transpose(1, 2)
                   for _ in range(3))
        shares[dd] = float((fa_ops.flash_attention(q, k, v)
                            != fa_ref.flash_attention(q, k, v))
                           .float().mean())
    assert shares[d] <= 1.25 * shares[128], shares


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


#: head_dims beyond 16/32/64/128: the kernels' instantiations at 48, 80,
#: 96, 112 (zamba2-7b's); past 128, one block a q tile holding every
#: output column, at 144, 176, 208, 224, 240 and 256 (the tensor cores'
#: wide kernel with one warpgroup, split TF32's instantiations) and 272,
#: 384, 400 and 512 (each route's wide kernel, with owners of 128 columns:
#: 272 and 400 with a last owner of 16 or 80), and past 512 in chunks of
#: at most 384 columns at 528, 576 and 1,024 (q.k over the whole head_dim
#: in rounds); and head_dims they reach by zero padding (1, 40, 57, 72,
#: 100, 113, 127, 200, 257)
ANY_D = [1, 40, 48, 57, 72, 80, 96, 100, 112, 113, 127, 144, 176, 200,
         208, 224, 240, 256, 257, 272, 384, 400, 512, 528, 576, 1024]


def any_head_dim_case(d: int, causal: bool, dtype, which: str) -> None:
    """(2, 4, 90, d) q over (2, 2, 130, d) k and v: launches route
    ``which``'s kernel once and agrees with the plain version."""
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to("cuda", dtype) for s in ((2, 4, 90, d), (2, 2, 130, d),
                                            (2, 2, 130, d)))
    assert fa_ops.route(dtype, d) == which
    before = fa_ops.counts[which]
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa_ops.counts[which] == before + 1
    want = fa_ref.flash_attention(q, k, v, causal=causal)
    assert got.shape == want.shape and got.dtype == dtype
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("d", ANY_D)
@pytest.mark.parametrize("causal", [True, False])
def test_tf32x3_kernel_takes_any_head_dim(card, no_tf32, d, causal):
    """f32 at every head_dim: the split-TF32 kernel (its wide kernel past
    256)."""
    any_head_dim_case(d, causal, torch.float32, "tf32x3")


@pytest.mark.parametrize("d", ANY_D)
@pytest.mark.parametrize("causal", [True, False])
def test_tensor_core_kernel_takes_any_head_dim(card, d, causal):
    """bf16 at every head_dim: the tensor-core kernel, at its own
    instantiation (48, 80, 96, 112), its wide kernel past 128, or on
    zero-padded copies."""
    any_head_dim_case(d, causal, torch.bfloat16, "tensor_core")


def test_bf16_past_128_launches_only_the_tensor_core_kernel(card):
    """bf16 at head_dims 144 to 256 (and 272) launches the tensor-core
    kernel, once a call, and never the split-TF32 one."""
    rng = np.random.default_rng(144)
    before = dict(fa_ops.counts)
    ds = (144, 160, 192, 200, 240, 256, 272)
    for d in ds:
        q, k, v = (torch.from_numpy(rng.standard_normal((1, 4, 70, d))
                                    .astype(np.float32))
                   .to("cuda", torch.bfloat16) for _ in range(3))
        assert fa_ops.route(q.dtype, d) == "tensor_core"
        fa_ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa_ops.counts["tensor_core"] == before["tensor_core"] + len(ds)
    assert fa_ops.counts["tf32x3"] == before["tf32x3"]


def test_tensor_core_kernel_reads_a_misaligned_view_through_a_copy(card):
    """bf16 at head_dim 112 one element into its buffer: TMA cannot read
    it in place, so the wrapper hands the tensor-core kernel an aligned
    copy (at 64 and 128 it refuses such a view)."""
    rng = np.random.default_rng(21)
    q = torch.zeros(1 + 2 * 4 * 200 * 112, dtype=torch.bfloat16,
                    device="cuda")[1:].view(2, 4, 200, 112)
    q.copy_(torch.from_numpy(rng.standard_normal((2, 4, 200, 112)).astype(
        np.float32)).to("cuda", torch.bfloat16))
    k, v = (torch.from_numpy(rng.standard_normal((2, 2, 200, 112)).astype(
        np.float32)).to("cuda", torch.bfloat16) for _ in range(2))
    assert q.data_ptr() % 16
    before = dict(fa_ops.counts)
    got = fa_ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa_ops.counts["tensor_core"] == before["tensor_core"] + 1
    assert fa_ops.counts["tf32x3"] == before["tf32x3"]
    want = fa_ref.flash_attention(q.contiguous(), k, v)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


def test_smallest_head_dim_112_input_on_the_card(card, no_tf32):
    q, k, v = (torch.from_numpy(np.random.default_rng(112).standard_normal(
        (1, 1, 1, 112)).astype(np.float32)).cuda() for _ in range(3))
    torch.testing.assert_close(fa_ops.flash_attention(q, k, v),
                               fa_ref.flash_attention(q, k, v),
                               rtol=2e-5, atol=2e-5)


def test_smallest_head_dim_129_input_on_the_card(card, no_tf32):
    """q, k and v of shape (1, 1, 1, 129): the smallest input the card
    refused while the kernel stopped at head_dim 128."""
    q, k, v = (torch.from_numpy(np.random.default_rng(129).standard_normal(
        (1, 1, 1, 129)).astype(np.float32)).cuda() for _ in range(3))
    before = fa_ops.counts["tf32x3"]
    torch.testing.assert_close(fa_ops.flash_attention(q, k, v),
                               fa_ref.flash_attention(q, k, v),
                               rtol=2e-5, atol=2e-5)
    assert fa_ops.counts["tf32x3"] == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [257, 272, 400, 512, 528])
def test_head_dim_past_256_runs_on_the_card(card, no_tf32, d, dtype):
    """Past head_dim 256, which the card refused until the kernels took
    every head_dim: (1, 1, 1, 257) q, k and v (the smallest such input)
    and a ragged (2, 4, 90) over (2, 2, 130) call run the route's kernel
    (split TF32 in f32, the tensor cores in bf16) and agree with the plain
    version."""
    which = fa_ops.route(dtype, d)
    assert which == ("tf32x3" if dtype == torch.float32 else "tensor_core")
    rng = np.random.default_rng(d)
    before = dict(fa_ops.counts)
    for qs, kvs in (((1, 1, 1, d), (1, 1, 1, d)),
                    ((2, 4, 90, d), (2, 2, 130, d))):
        q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   .to("cuda", dtype) for s in (qs, kvs, kvs))
        got = fa_ops.flash_attention(q, k, v)
        torch.cuda.synchronize()
        tol = FLASH_TOL[dtype]
        torch.testing.assert_close(got.float(),
                                   fa_ref.flash_attention(q, k, v).float(),
                                   rtol=tol, atol=tol)
    assert fa_ops.counts[which] == before[which] + 2
    assert fa_ops.counts["flash_attention"] == before["flash_attention"] + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [144, 256, 400, 512, 528])
def test_wide_kernels_give_bitwise_equal_outputs(card, no_tf32, d, dtype):
    """Past head_dim 128 a q tile is one block that sums in a fixed order
    (past 256 its owners add their partial scores through shared memory),
    with no atomics on the output: two launches on the same inputs give the
    same bits,
    causal and not, under GQA 4/2 with Lq < Lk over several q and kv
    tiles."""
    rng = np.random.default_rng(d + 7)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to("cuda", dtype) for s in ((2, 4, 150, d), (2, 2, 333, d),
                                            (2, 2, 333, d)))
    for causal in (True, False):
        first = fa_ops.flash_attention(q, k, v, causal=causal)
        second = fa_ops.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [256, 512])
def test_wide_kernels_count_qk_once_a_kv_tile(card, no_tf32, d, dtype):
    """Past head_dim 128 the kernels count the products they issue
    (``ops.counted_products``): q.k once for each (q tile, kv tile) pair
    the causal mask leaves, over all of D (three TF32 products each in
    f32), and P.V in three bf16 parts of p (bf16) or three TF32 products
    (f32), under GQA 4/2 at Lq = Lk = 300."""
    which = fa_ops.route(dtype, d)
    rng = np.random.default_rng(d + 11)
    b, hq, hkv, length = 2, 4, 2, 300
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to("cuda", dtype) for s in ((b, hq, length, d),
                                            (b, hkv, length, d),
                                            (b, hkv, length, d)))
    fa_ops.counted_products(which, reset=True)
    fa_ops.flash_attention(q, k, v)
    qk, pv = fa_ops.counted_products(which, reset=True)
    bq, bk = fa_ops._block_q(which, d), fa_ops._block_kv(which, d)
    pairs = fa_ops._tile_pairs(which, d, length, length)
    once = 2 * b * hq * pairs * bq * bk * d
    if dtype == torch.float32:
        assert (qk, pv) == (3 * once, 3 * once)
    else:
        assert (qk, pv) == (once, fa_ops.P_PARTS * once)
    assert fa_ops.counted_products(which) == (0, 0)


def test_kernels_blocks_a_q_tile_equal_out_chunks(card):
    """Each library's grid gives a q tile as many blocks as
    ``ops.out_chunks`` says, at every head_dim 16-1,024."""
    for fn in (fa_ops.load("tensor_core").flash_attention_wgmma_chunks,
               fa_ops.load("tf32x3").flash_attention_tf32x3_chunks):
        assert [fn(d) for d in range(16, 1025, 16)] == [
            fa_ops.out_chunks(d) for d in range(16, 1025, 16)]


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b",
                                  "whisper-large-v3", "qwen3-moe-235b-a22b"])
def test_family_on_the_card_equals_its_plain_path(card, no_tf32, arch):
    """A reduced vlm, audio and moe model in f32 on the card: the kernel
    path (each prefill attention on the split-TF32 kernel, three a layer
    for whisper) against the plain path, logits within 1e-4 and greedy
    tokens equal."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import forward, init_params, make_batch

    cfg = configs.reduced(configs.get_config(arch), attention_impl="pallas")
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    batch = make_batch(cfg, 2, 24, seed=0, device="cuda")
    plain = dataclasses.replace(cfg, attention_impl="reference")
    per_layer = 3 if cfg.family == "audio" else 1
    before = dict(fa_ops.counts), dict(fa_ref.counts)
    got = forward(cfg, model, batch)
    assert fa_ops.counts["tf32x3"] == (before[0]["tf32x3"]
                                       + per_layer * cfg.n_layers)
    assert fa_ref.counts == before[1]
    torch.testing.assert_close(got, forward(plain, model, batch),
                               rtol=1e-4, atol=1e-4)
    tokens = [chip_smoke.greedy_on_card(torch, c, model, batch, 8, 40)[0]
              for c in (cfg, plain)]
    np.testing.assert_array_equal(tokens[0], tokens[1])


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


def test_tensor_core_kernel_at_zamba2s_attention_shape(card, no_tf32):
    """zamba2-7b's shared attention as its prefill calls it: bf16, B 4,
    32 q and kv heads, 2,048 positions, head_dim 112, causal, on the
    model's (B, S, H, D) layout viewed as (B, H, S, D).  It takes the
    tensor-core route, read in place through TMA, within bf16's 2e-2 of
    the plain version."""
    rng = np.random.default_rng(112)
    q, k, v = (torch.from_numpy(rng.standard_normal((4, 2048, 32, 112))
                                .astype(np.float32)).to("cuda", torch.bfloat16)
               .transpose(1, 2) for _ in range(3))
    assert fa_ops.route(torch.bfloat16, 112) == "tensor_core"
    before = dict(fa_ops.counts)
    got = fa_ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa_ops.counts["tensor_core"] == before["tensor_core"] + 1
    assert fa_ops.counts["tf32x3"] == before["tf32x3"]
    want = fa_ref.flash_attention(q, k, v)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("arch,overrides", [("xlstm-1.3b", {}),
                                            ("zamba2-7b", {"n_layers": 5})])
def test_ssm_and_hybrid_on_the_card_equal_the_cpu(card, no_tf32, arch,
                                                  overrides):
    """Reduced xlstm and zamba2 (5 layers: two superblocks and a tail
    block) in f32: the card's full-sequence logits within 1e-4 of the
    CPU's and its greedy tokens equal; zamba2's prefill launches the
    split-TF32 kernel once a shared-attention use."""
    from repro_torch import configs
    from repro_torch.models import forward, init_params, make_batch
    from repro_torch.serving import ServeConfig, ServingEngine

    cfg = configs.reduced(configs.get_config(arch), attention_impl="pallas",
                          **overrides)
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = make_batch(cfg, 2, 24, seed=0, device="cpu")
    want = forward(cfg, model, batch)
    prompts = batch["tokens"].numpy()
    on_cpu = ServingEngine(cfg, model, ServeConfig(max_len=32),
                           device="cpu").generate(prompts, 8)
    model = model.cuda()
    uses = cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else 0
    before = dict(fa_ops.counts), dict(fa_ref.counts)
    got = forward(cfg, model, {"tokens": batch["tokens"].cuda()})
    assert fa_ops.counts["tf32x3"] == before[0]["tf32x3"] + uses
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    on_card = ServingEngine(cfg, model, ServeConfig(max_len=32),
                            device="cuda").generate(prompts, 8)
    np.testing.assert_array_equal(on_card, on_cpu)
    assert fa_ops.counts["tf32x3"] == before[0]["tf32x3"] + 2 * uses
    assert fa_ref.counts == before[1]


@pytest.mark.parametrize("impl", ["reference", "blocked"])
def test_train_step_on_the_card_equals_the_cpu(card, no_tf32, impl):
    """One reduced stablelm ``train_step`` in f32 (every block
    recomputed) on the card and on the CPU from the same weights: the
    loss within 1e-5, every gradient within 1e-4 of its tensor's max-abs,
    and the card's weights after its AdamW step within the same of the
    CPU's AdamW on the card's gradients (chip_smoke.py's phase 17 (a) at
    the reduced size)."""
    import copy

    from repro_torch import configs
    from repro_torch.models import init_params
    from repro_torch.training.optimizer import (
        OptConfig, adamw_init, adamw_update,
    )
    from repro_torch.training.train_step import make_steps

    cfg = configs.reduced(configs.get_config("stablelm-1.6b"),
                          attention_impl=impl, remat="full")
    weights = init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 40)))
    runs = {}
    for dev in ("cpu", "cuda"):
        model = copy.deepcopy(weights).to(dev)
        steps = make_steps(cfg)
        opt = steps["init_opt"](model)
        loss, grads, _ = chip_smoke.train_step_recorded(
            torch, steps, model, opt, {"tokens": tokens.to(dev)})
        runs[dev] = loss, grads, dict(model.named_parameters())
    (l_cpu, g_cpu, _), (l_card, g_card, p_card) = runs["cpu"], \
        runs["cuda"]
    assert l_card == pytest.approx(l_cpu, rel=chip_smoke.TRAIN_LOSS_RTOL)
    assert chip_smoke.worst_rel(torch, g_card, g_cpu)[1] \
        <= chip_smoke.TRAIN_GRAD_REL
    stepped = dict(copy.deepcopy(weights).named_parameters())
    adamw_update(OptConfig(), stepped,       # make_steps' default
                 {n: g.cpu() for n, g in g_card.items()},
                 adamw_init(stepped))
    assert chip_smoke.worst_rel(torch, p_card, stepped)[1] \
        <= chip_smoke.TRAIN_GRAD_REL
    assert all(p.device.type == "cuda" for p in p_card.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_wrapper_raises_under_autograd_on_the_card(card, dtype):
    """No backward on either route: on CUDA tensors that require grad the
    wrapper raises before any build or launch; without grad it runs."""
    q, k, v = (torch.randn(1, 2, 32, 64, device="cuda", dtype=dtype)
               for _ in range(3))
    before = dict(fa_ops.counts), dict(fa_ref.counts)
    with pytest.raises(NotImplementedError, match="no backward"):
        fa_ops.flash_attention(q.requires_grad_(), k, v)
    assert fa_ops.counts == before[0] and fa_ref.counts == before[1]
    with torch.no_grad():
        out = fa_ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa_ops.counts["flash_attention"] == \
        before[0]["flash_attention"] + 1
    torch.testing.assert_close(out.float(), fa_ref.flash_attention(
        q.detach(), k, v).float(), rtol=2e-2, atol=2e-2)


def test_checkpoint_restores_to_the_card(card, tmp_path):
    """A checkpoint saved from the card (bf16 weights, f32 moments, an
    int32 step) restores onto it bit for bit with ``device="cuda"``, and
    onto the CPU with ``device="cpu"``."""
    from repro_torch.training.checkpoint import restore, save

    gen = torch.Generator(device="cuda").manual_seed(0)
    tree = {"params": {"w": torch.randn(64, 48, device="cuda",
                                        generator=gen).bfloat16()},
            "opt": {"m": {"w": torch.randn(64, 48, device="cuda",
                                           generator=gen)},
                    "step": torch.tensor(3, dtype=torch.int32,
                                         device="cuda")}}
    save(tmp_path, 3, tree)
    like = {"params": {"w": torch.zeros(64, 48, dtype=torch.bfloat16)},
            "opt": {"m": {"w": torch.zeros(64, 48)},
                    "step": torch.zeros((), dtype=torch.int32)}}
    for dev in ("cuda", "cpu"):
        out = restore(tmp_path, 3, like, device=dev)
        for got, want in ((out["params"]["w"], tree["params"]["w"]),
                          (out["opt"]["m"]["w"], tree["opt"]["m"]["w"]),
                          (out["opt"]["step"], tree["opt"]["step"])):
            assert got.device.type == dev and got.dtype == want.dtype
            assert torch.equal(chip_smoke.tensor_bits(torch, got.cpu()),
                               chip_smoke.tensor_bits(torch, want.cpu()))


# -- sharding on torch.distributed: a one-rank NCCL group -------------------

_NCCL = r'''
import dataclasses, json, sys
import torch
import torch.distributed as dist
from repro_torch import configs
from repro_torch.launch.mesh import init_from_store, make_local_mesh
from repro_torch.launch.train import TrainLoop
from repro_torch.models import init_params, loss_fn, make_batch, moe
from repro_torch.models.layers import Params
from repro_torch.models.transformer import param_shapes
from repro_torch.sharding import place, rules
from repro_torch.training.train_step import mesh_loss

torch.backends.cuda.matmul.allow_tf32 = False
tmp = sys.argv[1]
out = {"backend": init_from_store(dist.FileStore(tmp + "/store", 1), 0, 1,
                                  device="cuda")}
mesh = make_local_mesh(1, 1, device="cuda")
out["mesh"] = mesh.device_type
cfg = configs.reduced(configs.get_config("codeqwen1.5-7b"))
model = init_params(cfg, torch.Generator("cuda").manual_seed(0), "cuda")
batch = make_batch(cfg, 4, 16, seed=0, device="cuda")
with torch.no_grad():
    plain = float(loss_fn(cfg, model, batch)[0])
    place.distribute_model(model, rules.param_specs(
        cfg, param_shapes(cfg), mesh), mesh)
    out["loss"] = [plain, float(mesh_loss(cfg, model, batch, mesh))]
tcfg = configs.reduced(configs.get_config("stablelm-1.6b"))
runs = {}
for name, m in (("plain", None), ("mesh", mesh)):
    loop = TrainLoop(tcfg, batch=4, seq=16, ckpt_dir=f"{tmp}/{name}",
                     device="cuda", mesh=m)
    loop.init_or_restore()
    runs[name] = loop.run(3, log_every=100)
out["train"] = runs

mcfg = configs.reduced(configs.get_config("qwen3-moe-235b-a22b"),
                       moe_shard="ep")
p = init_params(mcfg, torch.Generator("cuda").manual_seed(1),
                "cuda").layers[0].moe
x = torch.randn((4, 16, mcfg.d_model), generator=torch.Generator(
    "cuda").manual_seed(2), device="cuda")
moe.set_mesh(mesh)
cpu = moe.moe_apply(Params(**{k: v.detach().cpu() for k, v in
                              p.named_parameters()}), mcfg, x.cpu())
place.distribute_model(p, {k: rules.param_specs(
    mcfg, {f"layers.0.moe.{k}": v}, mesh)[f"layers.0.moe.{k}"]
    for k, v in p.named_parameters()}, mesh)
card = moe.moe_apply(p, mcfg, x)
out["ep_err"] = float((card.cpu() - cpu).abs().max())
out["ep_device"] = card.device.type
moe.set_mesh(None)

# tensor parallelism on the one-rank model axis: the sequence-parallel
# step's gradients, and greedy serving of the placed model and cache
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.transformer import decode_step, prefill
from repro_torch.sharding import tp

scfg = dataclasses.replace(cfg, act_shard="seq_model")
grads = {}
for name, m in (("plain", None), ("mesh", mesh)):
    model = init_params(scfg, torch.Generator("cuda").manual_seed(0), "cuda")
    if m is not None:
        place.distribute_model(model, rules.param_specs(
            scfg, param_shapes(scfg), m), m)
    model.requires_grad_(True)
    _, share = mesh_loss(scfg, model, batch, m, with_local=True)
    grads[name] = [g.full_tensor() if place.is_dtensor(g) else g for g in
                   torch.autograd.grad(share, list(model.parameters()))]
    if m is not None:
        out["tp_axis"] = list(tp.axis_of(scfg, model.parameters())[:2])
out["tp_grad_err"] = max(float((a - b).abs().max() / b.abs().max())
                         for a, b in zip(grads["mesh"], grads["plain"]))
pcfg = dataclasses.replace(cfg, attention_impl="pallas")
served = {}
for name, m in (("plain", None), ("mesh", mesh)):
    model = init_params(pcfg, torch.Generator("cuda").manual_seed(0), "cuda")
    if m is not None:
        place.distribute_model(model, rules.param_specs(
            pcfg, param_shapes(pcfg), m, training=False), m)
    fa_ops.counts.update({k: 0 for k in fa_ops.counts})
    with torch.no_grad():
        logits, cache = prefill(pcfg, model, batch, 24)
        steps = [logits]
        for _ in range(4):
            logits, cache = decode_step(pcfg, model, cache,
                                        logits[:, -1].argmax(-1, keepdim=True))
            steps.append(logits)
    served[name] = (torch.stack(steps), dict(fa_ops.counts))
out["tp_serve_err"] = float((served["mesh"][0] - served["plain"][0]).abs().max())
out["tp_serve_launches"] = served["mesh"][1]["flash_attention"]

# a reduced hybrid (zamba2, a Mamba2 tail) placed by the inference specs:
# its tensor-parallel prefill against the same placed model's whole-weight
# path
from unittest import mock

hcfg = configs.reduced(configs.get_config("zamba2-7b"), n_layers=5,
                       attention_impl="pallas")
model = init_params(hcfg, torch.Generator("cuda").manual_seed(0), "cuda")
place.distribute_model(model, rules.param_specs(
    hcfg, param_shapes(hcfg), mesh, training=False), mesh)
hb = make_batch(hcfg, 2, 24, seed=0, device="cuda")
fa_ops.counts.update({k: 0 for k in fa_ops.counts})
with torch.no_grad():
    hybrid = {"tp": prefill(hcfg, model, hb, 28)}
    out["hybrid_launches"] = fa_ops.counts["flash_attention"]
    with mock.patch.object(tp, "axis_of", lambda *a: None):
        hybrid["whole"] = prefill(hcfg, model, hb, 28)
out["hybrid_tp_axis"] = list(tp.axis_of(hcfg, model.parameters())[:2])
out["hybrid_err"] = float((hybrid["tp"][0] - hybrid["whole"][0]).abs().max())
out["hybrid_placements"] = {k: str(v.placements) for k, v in
                            hybrid["tp"][1].items() if place.is_dtensor(v)}
dist.destroy_process_group()
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def nccl_run(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    tmp = tmp_path_factory.mktemp("nccl")
    repo = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-c", _NCCL, str(tmp)], capture_output=True,
        text=True, timeout=600, check=False,
        env=dict(os.environ, PYTHONPATH=str(repo / "src")))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_one_rank_nccl_mesh_runs_the_sharded_step(nccl_run):
    """A cuda mesh runs on NCCL; the sharded loss equals the plain one
    within 1e-6 relative (f32), and ``TrainLoop(mesh=)`` trains to the
    unsharded loop's losses within 1e-5 relative."""
    assert nccl_run["backend"] == "nccl" and nccl_run["mesh"] == "cuda"
    plain, sharded = nccl_run["loss"]
    assert abs(sharded - plain) <= 1e-6 * abs(plain)
    np.testing.assert_allclose(nccl_run["train"]["mesh"],
                               nccl_run["train"]["plain"], rtol=1e-5)


def test_tensor_parallel_step_and_serving_on_one_nccl_rank(nccl_run):
    """The (1, 1) mesh's model axis computes tensor-parallel through NCCL:
    the sequence-parallel step's gradients within 1e-5 of their max-abs
    of the unsharded step's (f32), and the placed model's prefill (on the
    flash kernel) and 4 decode steps within 1e-4 of the unsharded
    model's logits."""
    assert nccl_run["tp_axis"] == [1, 0]
    assert nccl_run["tp_grad_err"] <= 1e-5
    assert nccl_run["tp_serve_err"] <= 1e-4
    assert nccl_run["tp_serve_launches"] > 0


def test_hybrid_tensor_parallel_prefill_on_one_nccl_rank(nccl_run):
    """A reduced zamba2 (f32, 5 layers) placed by the inference specs on
    the one-rank NCCL mesh computes tensor-parallel (the Mamba2 mixers and
    the shared block): its prefill's logits within 1e-6 of the same placed
    model's whole-weight path's (one rank: the same products in the same
    order),
    its shared attention on the flash kernel, its cache placed by
    ``cache_pspec`` (the states by heads, the conv windows by channels)."""
    assert nccl_run["hybrid_tp_axis"] == [1, 0]
    assert nccl_run["hybrid_err"] <= 1e-6
    assert nccl_run["hybrid_launches"] == 2
    where = nccl_run["hybrid_placements"]
    assert where["m"] == "(Replicate(), Shard(dim=3))"
    assert where["conv"] == "(Replicate(), Shard(dim=4))"


def test_expert_parallel_on_the_card_equals_the_cpu(nccl_run):
    """``moe_apply_ep`` on the card (weights placed on the NCCL mesh)
    against the same function on the CPU, f32, within 1e-5."""
    assert nccl_run["ep_device"] == "cuda"
    assert nccl_run["ep_err"] < 1e-5
