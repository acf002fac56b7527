"""The decode-attention kernel's plain version, split plan and wrapper on
the CPU.

On CPU tensors the wrapper runs the plain version (``ref.py``), which
must equal the port's ``_reference_attention(kv_valid=)`` and the JAX
package's: f32 within 2e-5 (they sum in different orders), bf16 within
one rounding of the output (2**-7 of the value, plus 1e-5 near 0).  A
numpy model of the kernel's splits, its lanes' partial states and their
fixed-order merge holds the algorithm to the one-pass softmax.  The CUDA
kernel itself is held against the plain version on a card, in
tests/test_torch_decode_attention_cuda.py."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jax_attn  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels.decode_attention import ops, ref  # noqa: E402
from repro_torch.models import attention, decode_step, init_params  # noqa: E402
from repro_torch.models import prefill  # noqa: E402

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2 ** -7, atol=1e-5)}
LMAX = 40


def inputs(rng, b, hq, hkv, d, lmax=LMAX):
    return (rng.standard_normal((b, 1, hq, d)).astype(np.float32),
            rng.standard_normal((b, lmax, hkv, d)).astype(np.float32),
            rng.standard_normal((b, lmax, hkv, d)).astype(np.float32))


def close(got, want, dtype: str) -> None:
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("valid", [1, 17, LMAX])
@pytest.mark.parametrize("group", [1, 4, 7, 16])
@pytest.mark.parametrize("d", [64, 112, 128])
def test_plain_equals_both_reference_attentions(d, group, valid, dtype):
    hkv = 2
    q, k, v = inputs(np.random.default_rng(d + group + valid), 2,
                     group * hkv, hkv, d)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    before = ref.counts["decode_attention"]
    got = ops.decode_attention(tq, tk, tv, valid)
    assert ref.counts["decode_attention"] == before + 1
    assert got.dtype == tq.dtype and got.shape == tq.shape
    port = attention._reference_attention(tq, tk, tv, causal=False,
                                          kv_valid=valid)
    close(got.float().numpy(), port.float().numpy(), dtype)
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v))
    jax_out = jax_attn._reference_attention(jq, jk, jv, causal=False,
                                            kv_valid=valid)
    close(got.float().numpy(), jax_out.astype(jnp.float32), dtype)


#: (blocks a split, valid positions, SMs): a full card, the decode batch,
#: chip_smoke's batch 4, one block, a short cache, a long one
PLANS = [(132, 5000, 132), (2048, 1088, 132), (128, 2064, 132),
         (1, 10_000, 132), (4, 100, 132), (4, 256, 132), (8, 700, 16),
         (30, 65_536, 132), (131, 100_000, 132)]


@pytest.mark.parametrize("blocks,valid,n_sm", PLANS)
def test_plan_covers_every_position_once(blocks, valid, n_sm):
    splits, rows = ops.plan(blocks, valid, n_sm)
    seen = np.zeros(valid, np.int64)
    for s in range(splits):
        lo, hi = s * rows, min((s + 1) * rows, valid)
        assert lo < hi                          # no split is empty
        seen[lo:hi] += 1
    assert (seen == 1).all()
    if blocks >= n_sm:
        assert splits == 1
    else:
        assert splits <= -(-2 * n_sm // blocks)
        assert splits == 1 or rows >= ops.MIN_SPLIT_ROWS


def test_plan_depends_on_the_block_count_alone():
    """Batch rows and kv heads enter only as their product: the benchmark's
    decode batch (64 x 32) fills the card and takes one split; batch 4
    leaves SMs idle and takes several."""
    assert ops.plan(64 * 32, 1088, 132) == ops.plan(32 * 64, 1088, 132) \
        == (1, 1088)
    assert ops.plan(4 * 32, 2064, 132) == ops.plan(128 * 1, 2064, 132)
    assert ops.plan(4 * 32, 2064, 132)[0] > 1
    assert ops.head_chunks(16) == 1 and ops.head_chunks(32) == 2


def kernel_model(q, k, v, valid, n_sm):
    """The kernel's arithmetic in numpy f32 for one batch row and kv head:
    q (G, D) (all heads of the kv head), k and v (L, D).  Splits by
    ``ops.plan``; within a split, tiles of R x bdz rows with row tz * R + r
    of a tile taken by lane group tz, each keeping its own running max
    (log2 domain), sum and accumulator; the groups merge in tz order, then
    the splits in split order."""
    f = np.float32
    g, d = q.shape
    lbx = max(0, int(np.ceil(np.log2(-(-d // 8)))))
    heads = min(g, ops.MAX_HEADS)
    lby = max(0, int(np.ceil(np.log2(-(-heads // 4)))))
    bdz, r_rows = 1 << (7 - lbx - lby), 4            # bfloat16's rows
    tile = r_rows * bdz
    splits, rows = ops.plan(1, valid, n_sm)
    qs = q.astype(f) * f(d ** -0.5 * np.log2(np.e))
    parts = []
    for s in range(splits):
        lo, hi = s * rows, min((s + 1) * rows, valid)
        m = np.full((bdz, g), -np.inf, f)
        l = np.zeros((bdz, g), f)
        o = np.zeros((bdz, g, d), f)
        for t0 in range(lo, hi, tile):
            for z in range(bdz):
                pos = t0 + z * r_rows + np.arange(r_rows)
                pos = pos[pos < hi]
                if not len(pos):
                    continue
                sc = (qs @ k[pos].T).astype(f)           # (g, rows)
                top = np.maximum(m[z], sc.max(axis=1))
                alpha = np.exp2(m[z] - top)
                p = np.exp2(sc - top[:, None])
                l[z] = l[z] * alpha + p.sum(axis=1)
                o[z] = o[z] * alpha[:, None] + p @ v[pos]
                m[z] = top
        top = m.max(axis=0)
        w = np.exp2(m - top)                              # (bdz, g)
        parts.append((top, (l * w).sum(axis=0),
                      (o * w[:, :, None]).sum(axis=0)))
    top = np.max([p[0] for p in parts], axis=0)
    w = [np.exp2(p[0] - top) for p in parts]
    total = sum(p[1] * wi for p, wi in zip(parts, w))
    acc = sum(p[2] * wi[:, None] for p, wi in zip(parts, w))
    return acc / total[:, None]


@pytest.mark.parametrize("g,d,valid,n_sm", [
    (1, 128, 1088, 132), (1, 128, 2064, 132), (16, 128, 700, 132),
    (7, 112, 300, 132), (1, 64, 9999, 132), (4, 256, 17, 132),
    (1, 16, 1, 132), (8, 128, 5000, 4)])
def test_split_and_lane_merge_equal_the_one_pass_softmax(g, d, valid, n_sm):
    rng = np.random.default_rng(g * d + valid)
    q = rng.standard_normal((g, d)).astype(np.float32)
    k = rng.standard_normal((valid + 3, d)).astype(np.float32)
    v = rng.standard_normal((valid + 3, d)).astype(np.float32)
    s = (q.astype(np.float64) @ k[:valid].T.astype(np.float64)) * d ** -0.5
    p = np.exp(s - s.max(axis=1, keepdims=True))
    want = (p / p.sum(axis=1, keepdims=True)) @ v[:valid].astype(np.float64)
    np.testing.assert_allclose(kernel_model(q, k, v, valid, n_sm), want,
                               rtol=2e-5, atol=2e-5)


def test_strided_layer_view_equals_contiguous():
    """A layer's view of the stacked (L, B, Lmax, Hkv, D) cache goes in as
    it is, and gives what a contiguous copy gives."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 1, 8, 64))
                         .astype(np.float32))
    kc = torch.from_numpy(rng.standard_normal((3, 2, LMAX, 2, 64))
                          .astype(np.float32))
    vc = kc.flip(0).contiguous()
    got = ops.decode_attention(q, kc[1], vc[1], 23)
    want = ops.decode_attention(q, kc[1].contiguous(), vc[1].contiguous(), 23)
    assert torch.equal(got, want)


def bad(**change):
    q = torch.zeros((2, 1, 4, 64))
    k = torch.zeros((2, LMAX, 2, 64))
    args = {"q": q, "k": k, "v": k.clone(), "valid": 5}
    args.update(change)
    return args


@pytest.mark.parametrize("case,args", [
    ("float16", bad(q=torch.zeros((2, 1, 4, 64), dtype=torch.float16),
                    k=torch.zeros((2, LMAX, 2, 64), dtype=torch.float16),
                    v=torch.zeros((2, LMAX, 2, 64), dtype=torch.float16))),
    ("mixed_dtypes", bad(q=torch.zeros((2, 1, 4, 64),
                                       dtype=torch.bfloat16))),
    ("head_dim_24", bad(q=torch.zeros((2, 1, 4, 24)),
                        k=torch.zeros((2, LMAX, 2, 24)),
                        v=torch.zeros((2, LMAX, 2, 24)))),
    ("head_dim_272", bad(q=torch.zeros((2, 1, 4, 272)),
                         k=torch.zeros((2, LMAX, 2, 272)),
                         v=torch.zeros((2, LMAX, 2, 272)))),
    ("valid_0", bad(valid=0)),
    ("valid_past_lmax", bad(valid=LMAX + 1)),
    ("two_positions", bad(q=torch.zeros((2, 2, 4, 64)))),
    ("heads_not_a_multiple", bad(q=torch.zeros((2, 1, 3, 64)))),
    ("k_offset_by_one", bad(k=torch.zeros(2 * LMAX * 2 * 64 + 1)[1:]
                            .view(2, LMAX, 2, 64))),
    ("v_position_stride_odd", bad(v=torch.zeros((2, LMAX, 2 * 64 + 1))
                                  [..., :128].view(2, LMAX, 2, 64))),
])
def test_wrapper_raises_on_what_the_kernel_does_not_take(case, args):
    before = dict(ref.counts), dict(ops.counts)
    with pytest.raises(ValueError):
        ops.decode_attention(args["q"], args["k"], args["v"], args["valid"])
    assert (dict(ref.counts), dict(ops.counts)) == before


def test_wrapper_raises_under_autograd():
    q = torch.zeros((1, 1, 2, 16), requires_grad=True)
    k = torch.zeros((1, 4, 2, 16))
    with pytest.raises(NotImplementedError):
        ops.decode_attention(q, k, k, 2)
    with torch.no_grad():
        assert ops.decode_attention(q, k, k, 2).shape == q.shape


def test_cpu_path_launches_no_kernel():
    before = dict(ops.counts)
    q, k, v = (torch.from_numpy(a) for a in inputs(
        np.random.default_rng(0), 1, 4, 2, 64))
    ops.decode_attention(q, k, v, 9)
    assert ops.counts == before


def reduced(impl: str):
    return configs.reduced(configs.get_config("codeqwen1.5-7b"),
                           attention_impl=impl, n_kv_heads=2)


@pytest.mark.parametrize("impl,calls", [("pallas", 1), ("reference", 0),
                                        ("blocked", 0)])
def test_decode_attention_routes_to_the_kernel_only_under_pallas(
        monkeypatch, impl, calls):
    """``decode_step`` reaches the kernel's wrapper once a layer under
    ``"pallas"`` and never otherwise; the tokens are the same."""
    seen = []
    wrapped = ops.decode_attention

    def spy(*a, **kw):
        seen.append(a[3])
        return wrapped(*a, **kw)

    monkeypatch.setattr(ops, "decode_attention", spy)
    cfg = reduced(impl)
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 6)))
    logits, cache = prefill(cfg, model, {"tokens": tokens}, 9)
    out, _ = decode_step(cfg, model, cache, tokens[:, :1])
    assert seen == [7] * (calls * cfg.n_layers)
    monkeypatch.setattr(ops, "decode_attention", wrapped)
    plain = dataclasses.replace(cfg, attention_impl="reference")
    _, cache = prefill(plain, model, {"tokens": tokens}, 9)
    want, _ = decode_step(plain, model, cache, tokens[:, :1])
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("pos", [0, 5, 15])
def test_pallas_decode_attention_equals_the_jax_package(pos):
    """The port's ``decode_attention`` under ``"pallas"`` (the kernel's
    plain version on the CPU) against the JAX package's plain decode."""
    from repro import configs as jax_configs

    jcfg = jax_configs.reduced(jax_configs.get_config("codeqwen1.5-7b"),
                               n_kv_heads=2)
    tcfg = reduced("pallas")
    rng = np.random.default_rng(4)
    d, hq, hkv, hd = tcfg.d_model, tcfg.n_heads, tcfg.n_kv_heads, \
        tcfg.head_dim
    w = {"wq": rng.standard_normal((d, hq * hd)),
         "wk": rng.standard_normal((d, hkv * hd)),
         "wv": rng.standard_normal((d, hkv * hd)),
         "wo": rng.standard_normal((hq * hd, d))}
    w = {n: (a * d ** -0.5).astype(np.float32) for n, a in w.items()}
    x = rng.standard_normal((2, 1, d)).astype(np.float32)
    kc, vc = (rng.standard_normal((2, 16, hkv, hd)).astype(np.float32)
              for _ in range(2))
    before = ref.counts["decode_attention"]
    with torch.no_grad():
        got, gk, _ = attention.decode_attention(
            {n: torch.from_numpy(a) for n, a in w.items()}, tcfg,
            torch.from_numpy(x), torch.from_numpy(kc.copy()),
            torch.from_numpy(vc.copy()), pos)
    assert ref.counts["decode_attention"] == before + 1
    want, wk, _ = jax_attn.decode_attention(
        {n: jnp.asarray(a) for n, a in w.items()}, jcfg, jnp.asarray(x),
        jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(pos, jnp.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), rtol=1e-5,
                               atol=1e-5)
