"""The decode-attention kernel against its plain version, on a card.

Tolerances: float32 within 2e-5 with TF32 off (the plain version's
products then run in true f32; only the order of the sums differs);
bfloat16 within one rounding of the output, 2**-7 of the value (a bf16
ulp is at most that) plus 1e-5 for the f32 sums' own difference near 0.

Marked ``cuda``: without a card the tests skip.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda \\
        tests/test_torch_decode_attention_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import ops, ref  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=2 ** -7, atol=1e-5)}

#: (B, Hq, Hkv, D, Lmax, valid): the benchmark's decode batch (one
#: split); chip_smoke's batch 4 (several splits); GQA 8 (command-r) and 16
#: (qwen3-moe); 7 (yi) and 6 (grok), whose heads leave a lane's slots
#: empty; 32 (two head chunks); head_dims 64 (stablelm, whisper), 112
#: (zamba2), 16 and 256; valid 1, 17 and Lmax
CASES = [(64, 32, 32, 128, 1152, 1088), (4, 32, 32, 128, 2080, 2049),
         (2, 64, 8, 128, 700, 700), (2, 64, 4, 128, 1500, 1333),
         (3, 56, 8, 128, 300, 17), (2, 48, 8, 128, 64, 1),
         (1, 32, 1, 64, 900, 899), (5, 32, 32, 64, 90, 90),
         (2, 32, 32, 112, 3000, 2500), (3, 8, 2, 16, 40, 17),
         (2, 16, 4, 256, 600, 513), (1, 4, 4, 256, 10_000, 9_999)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture
def no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def layer_view(gen, b, hq, hkv, d, lmax, dtype):
    """q (B, 1, Hq, D) and layer 1's k and v views of a stacked
    (2, B, Lmax, Hkv, D) cache, as a decode step gets them."""
    q = torch.randn((b, 1, hq, d), generator=gen, device="cuda").to(dtype)
    kc, vc = (torch.randn((2, b, lmax, hkv, d), generator=gen,
                          device="cuda").to(dtype) for _ in range(2))
    return q, kc[1], vc[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,hq,hkv,d,lmax,valid", CASES)
def test_kernel_equals_plain(card, no_tf32, dtype, b, hq, hkv, d, lmax,
                             valid):
    gen = torch.Generator(device="cuda").manual_seed(b * 1000 + hq + d)
    q, k, v = layer_view(gen, b, hq, hkv, d, lmax, dtype)
    splits, _ = ops.plan(b * hkv * ops.head_chunks(hq // hkv), valid,
                         torch.cuda.get_device_properties(0)
                         .multi_processor_count)
    before = dict(ops.counts), dict(ref.counts)
    got = ops.decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert ops.counts == {"decode_attention": before[0]["decode_attention"]
                          + 1, "merge": before[0]["merge"]
                          + int(splits > 1)}
    assert ref.counts == before[1]
    want = ref.decode_attention(q, k, v, valid)
    assert got.dtype == dtype and got.shape == (b, 1, hq, d)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_small_batch_takes_splits_and_repeats_its_bits(card):
    """chip_smoke's batch 4: more than one split, merged in a fixed
    order, so two launches give the same bits."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v = layer_view(gen, 4, 32, 32, 128, 2080, torch.bfloat16)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    assert ops.plan(4 * 32, 2049, n_sm)[0] > 1
    a = ops.decode_attention(q, k, v, 2049)
    b = ops.decode_attention(q, k, v, 2049)
    assert torch.equal(a, b)


def test_kernel_reads_only_the_valid_prefix(card):
    """Positions at and past ``valid`` hold NaN: the output stays finite
    and equals the plain version's on the prefix."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = layer_view(gen, 4, 32, 8, 128, 512, torch.bfloat16)
    k[:, 300:] = float("nan")
    v[:, 300:] = float("nan")
    got = ops.decode_attention(q, k, v, 300)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(),
                               ref.decode_attention(q, k, v, 300).float(),
                               **TOL[torch.bfloat16])


def serve(cfg, model, prompts, new):
    from repro_torch.serving import ServeConfig, ServingEngine

    return ServingEngine(cfg, model, ServeConfig(max_len=prompts.shape[1]
                                                 + new),
                         device="cuda").generate(prompts, new)


def test_decode_step_under_pallas_gives_the_reference_tokens(card, no_tf32):
    """A reduced dense model (codeqwen's block, f32): greedy tokens under
    ``"pallas"`` equal those under ``"reference"``, and the kernel runs
    once a layer a decode step, the plain version never."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import init_params

    cfg = configs.reduced(configs.get_config("codeqwen1.5-7b"),
                          attention_impl="pallas", head_dim=64)
    model = init_params(cfg, torch.Generator().manual_seed(0),
                        device="cpu").cuda()
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (3, 300)).astype(np.int32)
    new = 8
    before = dict(ops.counts), dict(ref.counts)
    got = serve(cfg, model, prompts, new)
    assert ops.counts["decode_attention"] == (
        before[0]["decode_attention"] + cfg.n_layers * new)
    assert ref.counts == before[1]
    want = serve(dataclasses.replace(cfg, attention_impl="reference"), model,
                 prompts, new)
    np.testing.assert_array_equal(got, want)
