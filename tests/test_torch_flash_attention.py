"""The port's flash attention against the JAX package's on the CPU.

On CPU tensors the port's wrapper runs its plain PyTorch version, which
has the TPU kernel's semantics.  It must agree with the JAX kernel (in
interpret mode, as tests/test_kernels.py runs it) on the same grids:
f32 within 2e-5 (the two sum in different orders), bf16 within 2e-2
(one bf16 rounding of the output).  The CUDA kernel itself is held
against the plain version on a card, in tests/test_torch_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ops as jax_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402

#: tests/test_kernels.py's (b, hq, hkv, l, d) grid
GRID = [(1, 2, 2, 128, 64), (2, 4, 2, 128, 64), (1, 8, 1, 256, 32),
        (1, 2, 2, 96, 64), (1, 4, 4, 130, 128)]


def qkv(rng, b, hq, hkv, lq, lk, d):
    return (rng.standard_normal((b, hq, lq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, lk, d)).astype(np.float32),
            rng.standard_normal((b, hkv, lk, d)).astype(np.float32))


def port(q, k, v, dtype=torch.float32, **kw) -> np.ndarray:
    out = ops.flash_attention(*(torch.from_numpy(a).to(dtype)
                                for a in (q, k, v)), **kw)
    assert out.dtype == dtype and out.device.type == "cpu"
    return out.float().numpy()


def jax_kernel(q, k, v, dtype=jnp.float32, **kw) -> np.ndarray:
    out = jax_ops.flash_attention(*(jnp.asarray(a, dtype) for a in (q, k, v)),
                                  block_q=64, block_k=64, **kw)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("b,hq,hkv,l,d", GRID)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_jax_kernel(b, hq, hkv, l, d, causal):
    q, k, v = qkv(np.random.default_rng(0), b, hq, hkv, l, l, d)
    before = ref.counts["flash_attention"]
    got = port(q, k, v, causal=causal)
    assert ref.counts["flash_attention"] == before + 1
    np.testing.assert_allclose(got, jax_kernel(q, k, v, causal=causal),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("lq,lk", [(8, 192), (1, 130), (64, 65)])
def test_decode_alignment_lq_lt_lk(lq, lk):
    """Few q rows attending a long end-aligned kv prefix."""
    q, k, v = qkv(np.random.default_rng(1), 1, 2, 2, lq, lk, 64)
    np.testing.assert_allclose(port(q, k, v), jax_kernel(q, k, v),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("lq,lk", [(100, 40), (130, 1)])
def test_fully_masked_rows_are_zero_like_the_jax_kernel(lq, lk):
    """Causal with Lq > Lk: the first Lq - Lk rows see no column and come
    out 0 (the oracle ref.gqa_attention would give NaN)."""
    q, k, v = qkv(np.random.default_rng(2), 1, 2, 1, lq, lk, 32)
    got = port(q, k, v)
    assert np.isfinite(got).all()
    assert not got[:, :, :lq - lk].any()
    assert np.abs(got[:, :, lq - lk:]).sum() > 0
    np.testing.assert_allclose(got, jax_kernel(q, k, v), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_gqa_group_seven(causal):
    """yi-34b's 56 q heads over 8 kv heads, cut to 14 over 2."""
    q, k, v = qkv(np.random.default_rng(3), 1, 14, 2, 80, 80, 16)
    np.testing.assert_allclose(port(q, k, v, causal=causal),
                               jax_kernel(q, k, v, causal=causal),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_dtypes(dtype, tol):
    q, k, v = qkv(np.random.default_rng(2), 1, 2, 1, 128, 128, 64)
    got = port(q, k, v, dtype=getattr(torch, dtype))
    want = jax_kernel(q, k, v, dtype=getattr(jnp, dtype))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_sm_scale():
    q, k, v = qkv(np.random.default_rng(5), 1, 2, 2, 64, 64, 16)
    np.testing.assert_allclose(port(q, k, v, sm_scale=0.3),
                               jax_kernel(q, k, v, sm_scale=0.3),
                               rtol=2e-5, atol=2e-5)


def test_causality_property():
    """Changing future kv must not change past outputs."""
    q, k, v = qkv(np.random.default_rng(4), 1, 2, 2, 128, 128, 64)
    out1 = port(q, k, v)
    k2, v2 = k.copy(), v.copy()
    k2[:, :, 100:] = 99.0
    v2[:, :, 100:] = -99.0
    out2 = port(q, k2, v2)
    np.testing.assert_allclose(out1[:, :, :100], out2[:, :, :100],
                               rtol=1e-6, atol=1e-6)


def test_strided_views_equal_contiguous():
    """The model hands over (B, S, H, D) activations as (B, H, S, D)
    views; the result equals that of contiguous copies."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 70, 4, 32)).astype(
        np.float32))
    kv = torch.from_numpy(rng.standard_normal((2, 70, 2, 32)).astype(
        np.float32))
    views = (x.transpose(1, 2), kv.transpose(1, 2), kv.transpose(1, 2))
    got = ops.flash_attention(*views)
    want = ops.flash_attention(*(t.contiguous() for t in views))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_empty_kv_gives_zeros():
    q = torch.ones((1, 2, 5, 16))
    k = torch.ones((1, 2, 0, 16))
    out = ops.flash_attention(q, k, k, causal=False)
    assert out.shape == q.shape and not out.any()


#: head_dims the JAX kernel computes and the split-TF32 kernel reaches by
#: zero padding (40, 72, 200) or by its own instantiation (80, 96, 112:
#: zamba2-7b's; 144 and 256, one block a q tile holding every output
#: column), and past 256 by its wide kernel (272: a last owner of 16
#: columns; 384 and 512: three and four owners of 128)
ANY_D = [40, 72, 80, 96, 112, 144, 200, 256, 272, 384, 512]


@pytest.mark.parametrize("d", ANY_D)
@pytest.mark.parametrize("causal", [True, False])
def test_any_head_dim_matches_jax_kernel(d, causal):
    """The reference takes any head_dim; so does the port (on the CPU its
    plain version, on a card the split-TF32 kernel in f32)."""
    q, k, v = qkv(np.random.default_rng(d), 1, 4, 2, 96, 96, d)
    np.testing.assert_allclose(port(q, k, v, causal=causal),
                               jax_kernel(q, k, v, causal=causal),
                               rtol=1e-5, atol=1e-5)


def test_any_head_dim_1024_matches_jax_kernel():
    """head_dim 1,024 (three chunks of at most 384 output columns on
    either route, each computing q.k over all 1,024 columns), GQA 2/1
    over a ragged 40 positions, in f32 within 1e-5."""
    q, k, v = qkv(np.random.default_rng(1024), 1, 2, 1, 40, 40, 1024)
    np.testing.assert_allclose(port(q, k, v), jax_kernel(q, k, v),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_head_dim_112_matches_jax_kernel(causal):
    """zamba2-7b's shared attention in bf16 at head_dim 112 (the
    tensor-core route on a card), GQA 4/2 over a ragged 130 positions,
    against the JAX kernel in bf16: within 2e-2, one bf16 rounding of the
    output, as the card tests hold it."""
    q, k, v = qkv(np.random.default_rng(1120), 1, 4, 2, 130, 130, 112)
    np.testing.assert_allclose(
        port(q, k, v, dtype=torch.bfloat16, causal=causal),
        jax_kernel(q, k, v, dtype=jnp.bfloat16, causal=causal),
        rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("d", [256, 272])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_head_dim_past_128_matches_jax_kernel(d, causal):
    """bf16 past head_dim 128 (the tensor-core route's wide kernel on a
    card: one warpgroup at 256, three at 272, the last of 16 columns), GQA
    4/2 over a ragged 130 positions, against the JAX kernel in bf16 within
    2e-2."""
    q, k, v = qkv(np.random.default_rng(d + 1), 1, 4, 2, 130, 130, d)
    np.testing.assert_allclose(
        port(q, k, v, dtype=torch.bfloat16, causal=causal),
        jax_kernel(q, k, v, dtype=jnp.bfloat16, causal=causal),
        rtol=2e-2, atol=2e-2)


def test_smallest_head_dim_112_input_matches_jax_kernel():
    """q, k and v of shape (1, 1, 1, 112): the smallest input the port
    refused before it took every head_dim."""
    q, k, v = qkv(np.random.default_rng(112), 1, 1, 1, 1, 1, 112)
    np.testing.assert_allclose(port(q, k, v), jax_kernel(q, k, v),
                               rtol=1e-5, atol=1e-5)


def test_smallest_head_dim_129_input_matches_jax_kernel():
    """q, k and v of shape (1, 1, 1, 129): the smallest input a card
    refused while the kernel stopped at head_dim 128."""
    q, k, v = qkv(np.random.default_rng(129), 1, 1, 1, 1, 1, 129)
    np.testing.assert_allclose(port(q, k, v), jax_kernel(q, k, v),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d,want", [(1, 16), (16, 16), (40, 48), (72, 80),
                                    (112, 112), (113, 128), (128, 128),
                                    (129, 144), (144, 144), (160, 160),
                                    (192, 192), (200, 208), (255, 256),
                                    (256, 256), (257, 272), (512, 512)])
def test_kernel_head_dim(d, want):
    """A card call runs the kernel at ``d`` rounded up to 16: the
    split-TF32 kernel's instantiation there up to 256, its wide kernel
    past it (the tensor-core kernel's wide one past 128)."""
    assert ops.kernel_head_dim(d) == want
    assert want in ops.HEAD_DIMS or (want > ops.HEAD_DIMS[-1]
                                     and want % 16 == 0)


@pytest.mark.parametrize("d", [0, -1])
def test_kernel_head_dim_outside_the_kernels_raises(d):
    with pytest.raises(ValueError, match="head_dim"):
        ops.kernel_head_dim(d)


@pytest.mark.parametrize("d,chunks", [(16, 1), (128, 1), (144, 1),
                                      (208, 1), (256, 1), (272, 1),
                                      (400, 1), (512, 1), (528, 2),
                                      (784, 3), (1024, 3)])
def test_out_chunks(d, chunks):
    """Up to head_dim 512 a block of either route owns a q tile and every
    output column; past it the columns are cut into chunks of at most 384,
    a multiple of 64 each but the last, which holds the rest (a multiple of
    16), one chunk a block."""
    assert ops.out_chunks(d) == chunks
    width = ops._chunk_columns(d)
    if d <= 512:
        assert width == d
    else:
        assert width <= 384 and width % 64 == 0
    last = d - width * (chunks - 1)
    assert 0 < last <= width and last % 16 == 0


@pytest.mark.parametrize("d", [40, 72, 112, 200])
@pytest.mark.parametrize("causal", [True, False])
def test_zero_padding_to_the_kernel_head_dim_changes_nothing(d, causal):
    """What the card path computes for such a D: the function on copies
    zero-padded to ``kernel_head_dim(D)``, scaled by the true D's
    ``D ** -0.5``, then cut back to D columns."""
    q, k, v = (torch.from_numpy(a) for a in qkv(
        np.random.default_rng(d + 1), 1, 4, 2, 50, 70, d))
    dk = ops.kernel_head_dim(d)
    padded = [torch.nn.functional.pad(t, (0, dk - d)) for t in (q, k, v)]
    got = ref.flash_attention(*padded, causal=causal, sm_scale=d ** -0.5)
    assert not got[..., d:].any()
    torch.testing.assert_close(got[..., :d],
                               ref.flash_attention(q, k, v, causal=causal),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("head_dim", [1, 16, 32, 40, 48, 64, 80, 96, 112,
                                      128, 144, 256, 257, 272, 384, 512,
                                      1024])
def test_route(dtype, head_dim):
    """bf16 at every head_dim takes the wgmma kernel, at the instantiation
    of ``kernel_head_dim`` up to 128 and its wide kernel past it; f32 the
    split-TF32 kernel, which keeps f32 accuracy on the tensor cores."""
    want = "tensor_core" if dtype == "bfloat16" else "tf32x3"
    assert ops.route(getattr(torch, dtype), head_dim) == want
    assert want in ops.ROUTES
    dk = ops.kernel_head_dim(head_dim)
    if want == "tensor_core":
        assert dk in ops.TENSOR_CORE_HEAD_DIMS or (
            dk > ops.TENSOR_CORE_HEAD_DIMS[-1] and dk % 16 == 0)


def test_cpu_path_launches_no_kernel():
    """On CPU tensors every route's count stays 0: the plain version runs."""
    rng = np.random.default_rng(7)
    before = dict(ops.counts), ref.counts["flash_attention"]
    for dtype, d in ((torch.bfloat16, 128), (torch.bfloat16, 64),
                     (torch.bfloat16, 32), (torch.float32, 128)):
        q, k, v = (torch.from_numpy(a).to(dtype)
                   for a in qkv(rng, 1, 4, 2, 40, 40, d))
        ops.flash_attention(q, k, v)
    assert ops.counts == before[0]
    assert ref.counts["flash_attention"] == before[1] + 4


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_wrapper_raises_under_autograd(which):
    """Neither kernel has a backward (nor has the JAX kernel): where
    autograd would record the call the wrapper raises, on the CPU too,
    and runs nothing, not the differentiable plain version; under
    ``torch.no_grad()`` it computes."""
    rng = np.random.default_rng(8)
    t = dict(zip("qkv", (torch.from_numpy(a) for a in
                         qkv(rng, 1, 4, 2, 24, 24, 16))))
    t[which].requires_grad_()
    before = dict(ops.counts), ref.counts["flash_attention"]
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.flash_attention(t["q"], t["k"], t["v"])
    assert ops.counts == before[0]
    assert ref.counts["flash_attention"] == before[1]
    with torch.no_grad():
        out = ops.flash_attention(t["q"], t["k"], t["v"])
    assert not out.requires_grad
    assert ref.counts["flash_attention"] == before[1] + 1


def _offset_view(shape, dtype, offset=1):
    """A (B, H, L, D) view that starts ``offset`` elements into a buffer."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)


@pytest.mark.parametrize("case", ["base_misaligned", "position_stride",
                                  "kv_base_misaligned", "zero_stride"])
def test_tensor_core_route_rejects_unaligned_inputs(case):
    """The tensor-core kernel reads through TMA maps: 16-byte-aligned bases
    and strides.  The wrapper refuses anything else on any device, before
    it builds or launches a kernel."""
    bf16 = torch.bfloat16
    q = torch.zeros((1, 4, 8, 64), dtype=bf16)
    k = v = torch.zeros((1, 2, 8, 64), dtype=bf16)
    if case == "base_misaligned":
        q = _offset_view((1, 4, 8, 64), bf16)
    elif case == "position_stride":      # rows 68 elements = 136 B apart
        q = torch.zeros((1, 4, 8, 68), dtype=bf16)[..., :64]
    elif case == "kv_base_misaligned":
        v = _offset_view((1, 2, 8, 64), bf16, offset=4)
    elif case == "zero_stride":
        k = torch.zeros((1, 1, 8, 64), dtype=bf16).expand(1, 2, 8, 64)
    before = dict(ops.counts), dict(ref.counts)
    with pytest.raises(ValueError, match="aligned|multiples"):
        ops.flash_attention(q, k, v)
    assert (ops.counts, ref.counts) == before


@pytest.mark.parametrize("dtype,d", [("float32", 64), ("bfloat16", 32),
                                     ("bfloat16", 144)])
def test_cuda_core_route_takes_unaligned_inputs(dtype, d):
    """Views the wgmma route refuses at head_dim 64 and 128 go in at the
    others: an offset view gives what a contiguous copy gives (on a card
    the split-TF32 kernel, f32, copies 4 bytes at a time there, not 16;
    the tensor-core kernel, bf16 at 32 and 144, reads an aligned copy)."""
    dtype = getattr(torch, dtype)
    q = _offset_view((1, 4, 8, d), dtype)
    q.copy_(torch.from_numpy(np.random.default_rng(8).standard_normal(
        (1, 4, 8, d)).astype(np.float32)).to(dtype))
    k = torch.ones((1, 2, 8, d), dtype=dtype)
    torch.testing.assert_close(ops.flash_attention(q, k, k),
                               ops.flash_attention(q.contiguous(), k, k),
                               rtol=0, atol=0)


def test_misaligned_bf16_head_dim_112_runs_the_plain_version():
    """bf16 at head_dim 112 takes the tensor-core route, whose TMA loads
    need 16-byte-aligned bases.  A view one element into its buffer, which
    the CPU computed before that route took head_dim 112, still does: the
    plain version runs and nothing raises (on a card the kernel reads an
    aligned copy)."""
    bf16 = torch.bfloat16
    assert ops.route(bf16, 112) == "tensor_core"
    q = _offset_view((1, 4, 20, 112), bf16)
    q.copy_(torch.from_numpy(np.random.default_rng(9).standard_normal(
        (1, 4, 20, 112)).astype(np.float32)).to(bf16))
    assert q.data_ptr() % 16
    k = torch.ones((1, 2, 20, 112), dtype=bf16)
    before = dict(ops.counts), ref.counts["flash_attention"]
    got = ops.flash_attention(q, k, k)
    assert ops.counts == before[0]
    assert ref.counts["flash_attention"] == before[1] + 1
    torch.testing.assert_close(got, ref.flash_attention(q.contiguous(), k, k),
                               rtol=0, atol=0)


@pytest.mark.parametrize("case,exc", [
    ("float16", TypeError),
    ("mixed_dtypes", TypeError),
    ("rank_3", ValueError),
    ("head_dim_strided", ValueError),
    ("heads_not_multiple", ValueError),
    ("kv_shapes_differ", ValueError),
    ("batch_differs", ValueError),
])
def test_wrapper_rejects(case, exc):
    q = torch.zeros((1, 4, 8, 32))
    k = torch.zeros((1, 2, 8, 32))
    v = torch.zeros((1, 2, 8, 32))
    if case == "float16":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "mixed_dtypes":
        q = q.to(torch.bfloat16)
    elif case == "rank_3":
        q = q[0]
    elif case == "head_dim_strided":
        q = torch.zeros((1, 4, 8, 64))[..., ::2]
    elif case == "heads_not_multiple":
        q = torch.zeros((1, 3, 8, 32))
    elif case == "kv_shapes_differ":
        v = torch.zeros((1, 2, 9, 32))
    elif case == "batch_differs":
        k = v = torch.zeros((2, 2, 8, 32))
    with pytest.raises(exc):
        ops.flash_attention(q, k, v)


@pytest.mark.parametrize("which,b,hq,lq,fits", [
    # both grids are 1-D over (B * Hq) x q tiles (128 rows on the wgmma
    # route, 64 on split TF32): B * Hq past a y dimension's 65,535 fits
    ("tensor_core", 2048, 32, 2048, True),
    ("tensor_core", 1, 1, 128 * (2 ** 31 - 1), True),
    ("tensor_core", 2 ** 16, 2 ** 8, 128 * 2 ** 7, False),
    ("tf32x3", 2048, 32, 2048, True),
    ("tf32x3", 1, 1, 64 * (2 ** 31 - 1), True),
    ("tf32x3", 2 ** 16, 2 ** 8, 64 * 2 ** 7, False),
])
def test_grid_limits(which, b, hq, lq, fits):
    """Each route's grid holds these calls, or the wrapper raises before it
    launches."""
    if fits:
        ops._check_grid(which, b, hq, lq, 128)
    else:
        with pytest.raises(ValueError, match="grid"):
            ops._check_grid(which, b, hq, lq, 128)


@pytest.mark.parametrize("d,fits", [(128, True), (144, True),
                                    (512, True), (528, False),
                                    (1024, False)])
def test_grid_limits_count_the_output_chunks(d, fits):
    """Either route's grid holds ``out_chunks`` blocks a q tile of
    ``_block_q`` rows: 2^30 q tiles fit one block a tile (every head_dim
    to 512), not two or three (528: two chunks; 1,024: three); 2^28 fit
    three, at head_dim 1,024."""
    for which in ops.ROUTES:
        args = (which, 2 ** 16, 2 ** 8, ops._block_q(which, d) * 2 ** 6, d)
        if fits:
            ops._check_grid(*args)
        else:
            with pytest.raises(ValueError, match="grid"):
                ops._check_grid(*args)
    ops._check_grid("tensor_core", 2 ** 16, 2 ** 6, 64 * 2 ** 6, 1024)


@pytest.mark.parametrize("which,d,rows", [
    ("tensor_core", 128, 128), ("tensor_core", 144, 64),
    ("tensor_core", 1024, 64), ("tf32x3", 128, 64), ("tf32x3", 256, 64),
    ("tf32x3", 272, 32), ("tf32x3", 1024, 32)])
def test_block_q_follows_each_route_past_128(which, d, rows):
    """q rows a block holds: the tensor-core kernel 128 to head_dim 128,
    then one warpgroup's 64; the split-TF32 kernel 64 to 256, then 32 (its
    wide kernel's q, K and V tiles of every head_dim column then fit
    shared memory)."""
    assert ops._block_q(which, d) == rows



@pytest.mark.parametrize("which,d,rows", [
    ("tensor_core", 128, 128), ("tensor_core", 144, 64),
    ("tensor_core", 256, 64), ("tensor_core", 512, 64),
    ("tf32x3", 64, 64), ("tf32x3", 80, 32), ("tf32x3", 256, 32),
    ("tf32x3", 512, 32)])
def test_block_kv_follows_each_route(which, d, rows):
    """kv rows a tile: the tensor-core kernel 128 to head_dim 128, then its
    wide kernel's 64; the split-TF32 kernel 64 to 64, then 32."""
    assert ops._block_kv(which, d) == rows


@pytest.mark.parametrize("which", ["tensor_core", "tf32x3"])
@pytest.mark.parametrize("d", [144, 192, 256, 512])
def test_tile_pairs_count_each_kernels_tiles(which, d):
    """The (q tile, kv tile) pairs a causal call runs for one (batch,
    head), which chip_smoke.py's phase 8 and the card's count test divide
    the counted q.k by: every pair whose kv tile starts at or before the
    last column its q tile's last row sees (end-aligned), for Lq = Lk,
    Lq < Lk, Lq > Lk and a ragged last tile."""
    bq, bk = ops._block_q(which, d), ops._block_kv(which, d)
    for lq, lk in ((2048, 2048), (300, 300), (150, 333), (333, 150),
                   (1, 100), (100, 1)):
        want = sum(1 for q0 in range(0, lq, bq) for k0 in range(0, lk, bk)
                   if k0 <= min(q0 + bq, lq) - 1 + lk - lq)
        assert ops._tile_pairs(which, d, lq, lk) == want
    # at the prefill shape (B 4, H 32, L 2,048) the q.k the kernels
    # counted on the card (PERF.md, Findings; split TF32 three TF32
    # products of it): 1.4173e11 FLOP at D 256, 2.8347e11 on the tensor
    # cores and 2.7917e11 in split TF32 (32-row q tiles) at D 512
    counted = {256: 141733920768,
               512: 283467841536 if which == "tensor_core" else 279172874240}
    if d in counted:
        assert 2 * 4 * 32 * ops._tile_pairs(which, d, 2048, 2048) * bq * bk \
            * d == counted[d]


def tf32(x: torch.Tensor, rounded: bool = True) -> torch.Tensor:
    """f32 to TF32 (10 mantissa bits) on the int32 view, as the kernel
    does it: rounded to nearest, ties away from zero (``cvt.rna.tf32``'s
    rounding: add half of the dropped 13 bits to the magnitude, then clear
    them), or truncated (clear them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + (0x1000 if rounded else 0)) & ~0x1FFF).view(torch.float32)


def split_matmul(a: torch.Tensor, b: torch.Tensor, split: bool):
    """a @ b as the split-TF32 kernel takes it: each operand split into
    big = tf32(x) and small = x - big truncated to TF32, and the three
    products small*big, big*small, big*big summed in f32, small terms
    first; or, unsplit, one TF32 product.  TF32 x TF32 products are exact
    in f32."""
    ab, bb = tf32(a), tf32(b)
    if not split:
        return ab @ bb
    a_small, b_small = tf32(a - ab, False), tf32(b - bb, False)
    return a_small @ bb + ab @ b_small + ab @ bb


def emulated_attention(q, k, v, split: bool, causal: bool = True):
    """The kernel's arithmetic on the CPU: scores and P @ V through
    :func:`split_matmul`, the softmax in f32."""
    lq, lk, d = q.shape[2], k.shape[2], q.shape[3]
    s = split_matmul(q, k.transpose(-1, -2), split) * d ** -0.5
    if causal:
        rows = torch.arange(lq)[:, None] + (lk - lq)
        s = s.masked_fill(rows < torch.arange(lk)[None, :], float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return split_matmul(p, v, split) / p.sum(-1, keepdim=True)


@pytest.mark.parametrize("d", [32, 128])
def test_split_tf32_keeps_f32_accuracy_and_one_tf32_product_does_not(d):
    """Why the f32 route splits: with each f32 operand as a TF32 high and
    low part, three TF32 products per product stay within the f32 gate
    (2e-5 + 2e-5 * |plain|) of the plain version at D 32 and 128; one
    TF32 product (10 mantissa bits) misses it many times over."""
    q, k, v = (torch.from_numpy(a) for a in qkv(
        np.random.default_rng(14), 1, 2, 2, 128, 128, d))
    want = ref.flash_attention(q, k, v)
    x = torch.from_numpy(np.random.default_rng(15).standard_normal(
        1000).astype(np.float32))
    assert torch.equal(tf32(tf32(x)), tf32(x))
    assert ((tf32(x) - x).abs() <= x.abs() * 2.0 ** -11).all()
    rest = x - tf32(x)
    assert ((x - tf32(x) - tf32(rest, False)).abs()
            <= x.abs() * 2.0 ** -21).all()
    # a bf16 value is exact in TF32: bf16 operands need no split
    xb = x.to(torch.bfloat16).float()
    assert torch.equal(tf32(xb), xb)
    tol = 2e-5
    excess = {}
    for split in (True, False):
        diff = (emulated_attention(q, k, v, split) - want).abs()
        excess[split] = float((diff - tol * want.abs()).max())
    assert excess[True] <= tol
    assert excess[False] > 10 * tol


def test_flash_rounding_tool_finds_its_lines_in_the_kernel():
    """``tools/flash_rounding.py --chained`` rebuilds the tensor-core
    kernel with P.V chained through O: each line it edits is in the
    kernel's source exactly once, and the edit removes the tile sum."""
    from tools import flash_rounding

    src = (ops._CSRC / "flash_attention_wgmma.cu").read_text()
    chained = flash_rounding.chained_source(src)
    assert "fmaf(o[i], alpha" in src
    assert "fmaf(o[i], alpha" not in chained
    assert "wgmma_m64nNk16_rs<N>(o, a, dv, 1);" in chained
    with pytest.raises(ValueError, match="no longer has"):
        flash_rounding.chained_source(chained)


def test_flash_ab_reads_one_instantiations_sass():
    """``tools/flash_ab.py`` compares two libraries' instantiations of
    either flash kernel instruction by instruction: it takes the listing
    of one instantiation only (the tensor-core kernel's (head_dim, 3
    parts), the split-TF32 kernel's (type, head_dim, copy width)), without
    addresses or encodings."""
    from tools import flash_ab

    def function(d, parts, body):
        return (f"\t\tFunction : _ZN_flash_attention_wgmma_kernelILi{d}ELi"
                f"{parts}EEEv14CUtensorMap\n" + "".join(
                    f"        /*{i * 16:04x}*/   {op} ;   /* 0x{i:016x} */\n"
                    for i, op in enumerate(body)))

    sass = ("\tcode for sm_90a\n" + function(128, 3, ["MOV R1, c[0x0][0x28]",
                                                       "HGMMA.64x128x16"])
            + function(128, 2, ["EXIT"]) + function(112, 3, ["BRA 0x40"]))
    assert flash_ab.instructions(sass, 128) == ["MOV R1, c[0x0][0x28]",
                                                "HGMMA.64x128x16"]
    assert flash_ab.instructions(sass, 112) == ["BRA 0x40"]
    assert flash_ab.instructions(sass, 64) == []
    # the split-TF32 library: float32 with 16- and 4-byte copies, and bf16,
    # each apart from the others and from the wide kernel
    names = {"f32, 16-byte copies": "IfLi128ELb1EEEvPKT_",
             "f32, 4-byte copies": "IfLi128ELb0EEEvPKT_",
             "bf16": "I13__nv_bfloat16Li128ELb0EEEvPKT_"}
    sass = "\tcode for sm_90a\n" + "".join(
        f"\t\tFunction : _ZN_flash_attention_tf32x3_kernel{tail}\n"
        f"        /*0000*/   HMMA.1688.F32.TF32 R{i} ;   /* 0x0 */\n"
        for i, tail in enumerate(names.values())) + (
        "\t\tFunction : _ZN_flash_attention_tf32x3_wide_kernelILb1EEEv\n"
        "        /*0000*/   EXIT ;   /* 0x0 */\n")
    for i, label in enumerate(names):
        assert flash_ab.instructions(sass, 128, "tf32x3", label) == [
            f"HMMA.1688.F32.TF32 R{i}"]
    assert flash_ab.instructions(sass, 112, "tf32x3", "bf16") == []
    assert set(flash_ab.instantiations("tf32x3", 128)) == set(names)
