"""The port's blocked attention and its hand-written backward against the
JAX package's ``custom_vjp`` (``repro.models.blocked_attention``).

The grids are ``tests/test_blocked_attention.py``'s: GQA over several
blocks, MQA with 100 positions (not a multiple of the block), a single
block; causal and not; a ``kv_valid`` prefix; and rows that see no key.
q, k, v and the output's cotangent come from seeded numpy.  f32 forward
and gradients agree within 2e-5, the tolerance of the reference's own
test.  In bf16 both round p to bf16 before P.V and ds before dq and dk,
and accumulate in f32: the output is bitwise the reference's and each
gradient equal in at least 99% of its elements and within 1e-3 of its
max-abs (leaving out any one of those casts drops the output or a
gradient to 59-80% equal elements, 3e-3 to 6e-3 of its max-abs apart);
the f32 logsumexp the backward recomputes from is held within 1e-5.

In the model: ``attention_impl="blocked"``'s loss and gradients against
``jax.value_and_grad`` of the reference's blocked route for one dense and
one hybrid arch (``tests/test_torch_family_grads.py``'s tolerances), and
``remat="full"`` (every block under ``torch.utils.checkpoint``, where the
reference applies ``jax.checkpoint``) giving the gradients of
``"none"``."""

import dataclasses
import functools
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import blocked_attention as jax_blocked  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models import blocked_attention as blocked  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from test_torch_family_grads import (  # noqa: E402
    LOSS_RTOL, assert_grads_match, port_loss_and_grads, reference,
)

F32_TOL = dict(rtol=2e-5, atol=2e-5)
#: bf16 gradients: the share of elements equal to the reference's, and
#: the largest difference relative to the tensor's max-abs
BF16_EQUAL_SHARE, BF16_REL = 0.99, 1e-3

GRID = [(2, 4, 2, 64, 16, 16),
        (1, 8, 1, 100, 32, 32),    # MQA, seq not a multiple of the block
        (1, 2, 2, 128, 16, 128)]   # a single block


def inputs(seed, b, hq, hkv, sq, sk, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    dout = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    return q, k, v, dout


def jax_run(q, k, v, dout, dtype, **kw):
    """Output and (dq, dk, dv) of the reference, by its vjp."""
    args = [jnp.asarray(a).astype(dtype) for a in (q, k, v)]
    out, vjp = jax.vjp(
        lambda q, k, v: jax_blocked.blocked_attention(q, k, v, **kw), *args)
    grads = vjp(jnp.asarray(dout).astype(dtype))
    return [np.asarray(x, np.float32) for x in (out, *grads)]


def port_run(q, k, v, dout, dtype, **kw):
    args = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
    out = blocked.blocked_attention(*args, **kw)
    assert out.dtype == dtype
    out.backward(torch.from_numpy(dout).to(dtype))
    for a in args:
        assert a.grad.dtype == dtype
    return [x.detach().float().numpy()
            for x in (out, *(a.grad for a in args))]


@pytest.mark.parametrize("b,hq,hkv,s,d,blk", GRID)
@pytest.mark.parametrize("causal", [True, False])
def test_forward_and_grads_match_jax(b, hq, hkv, s, d, blk, causal):
    data = inputs(0, b, hq, hkv, s, s, d)
    kw = dict(causal=causal, block_k=blk)
    want = jax_run(*data, jnp.float32, **kw)
    got = port_run(*data, torch.float32, **kw)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, **F32_TOL, err_msg=name)


@pytest.mark.parametrize("b,hq,hkv,s,d,blk", GRID)
@pytest.mark.parametrize("causal", [True, False])
def test_forward_equals_the_reference_attention(b, hq, hkv, s, d, blk,
                                                causal):
    """The blocked loop computes the plain attention's function."""
    q, k, v, _ = (torch.from_numpy(a)
                  for a in inputs(1, b, hq, hkv, s, s, d))
    got = blocked.blocked_attention(q, k, v, causal=causal, block_k=blk)
    want = attention._reference_attention(q, k, v, causal=causal)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)


def test_grads_equal_autograd_through_the_reference_attention():
    """The hand-written backward against autograd of the plain attention
    (the reference's own grads test, at 5e-5)."""
    q, k, v, dout = (torch.from_numpy(a)
                     for a in inputs(2, 1, 4, 2, 48, 48, 16))
    grads = []
    for fn in (lambda q, k, v: blocked.blocked_attention(
                   q, k, v, block_k=16),
               lambda q, k, v: attention._reference_attention(
                   q, k, v, causal=True)):
        args = [t.clone().requires_grad_() for t in (q, k, v)]
        torch.sin(fn(*args)).sum().backward()
        grads.append([a.grad.numpy() for a in args])
    for g, w in zip(*grads):
        np.testing.assert_allclose(g, w, rtol=5e-5, atol=5e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_kv_valid_prefix_matches_jax(causal):
    data = inputs(3, 1, 2, 2, 8, 64, 16)
    kw = dict(causal=causal, kv_valid=40, block_k=16)
    want = jax_run(*data, jnp.float32, **kw)
    got = port_run(*data, torch.float32, **kw)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, **F32_TOL, err_msg=name)
    # keys past the prefix get no gradient
    assert not got[2][:, 40:].any() and not got[3][:, 40:].any()


def test_rows_that_see_no_key_give_zero():
    """End-aligned causal mask with Sq > Sk: the first Sq - Sk rows see no
    key, give 0 (logsumexp 0) and pass no gradient, as the reference's."""
    data = inputs(4, 1, 4, 2, 40, 16, 16)
    kw = dict(causal=True, block_k=8)
    want = jax_run(*data, jnp.float32, **kw)
    got = port_run(*data, torch.float32, **kw)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, **F32_TOL, err_msg=name)
    assert not got[0][:, :24].any() and not got[1][:, :24].any()
    assert got[0][:, 24:].any()


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_matches_jax(causal):
    """bf16 inputs: the output bitwise the reference's, the gradients
    equal but for the order of f32 sums; the f32 logsumexp the backward
    recomputes from within 1e-5 (it sees the same exact bf16 products)."""
    b, hq, hkv, s, d = 2, 4, 2, 100, 32
    data = inputs(5, b, hq, hkv, s, s, d)
    kw = dict(causal=causal, block_k=32)
    want = jax_run(*data, jnp.bfloat16, **kw)
    got = port_run(*data, torch.bfloat16, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    for name, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        assert (g == w).mean() >= BF16_EQUAL_SHARE, name
        assert np.abs(g - w).max() <= BF16_REL * np.abs(w).max(), name
    q, k, v = (jnp.asarray(a).astype(jnp.bfloat16) for a in data[:3])
    _, want_lse = jax_blocked._blocked_fwd_impl(
        q, k, v, causal, 32, s, None)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in data[:3])
    _, got_lse = blocked._forward(tq, tk, tv, causal, 32, None)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "zamba2-7b"])
def test_blocked_route_loss_and_grads_match_jax(arch):
    """A dense and a hybrid arch trained through the blocked route (2
    blocks of 16 keys over 24 positions): loss and every gradient against
    the reference's blocked route."""
    _, tcfg, params, want_loss, want_grads, tb = reference(
        arch, attention_impl="blocked")
    with mock.patch.object(transformer, "attention",
                           wraps=transformer.attention) as calls, \
            mock.patch.object(attention, "blocked_attention",
                              wraps=functools.partial(
                                  blocked.blocked_attention,
                                  block_k=16)) as blocked_calls:
        loss, grads = port_loss_and_grads(tcfg, params, tb)
    assert blocked_calls.call_count == calls.call_count > 0
    assert loss == pytest.approx(want_loss, rel=LOSS_RTOL)
    assert_grads_match(tcfg, grads, want_grads)


#: (arch, overrides, blocks the reference recomputes: dense blocks, mLSTM
#: blocks (not the sLSTM), Mamba2 blocks (not the shared attention),
#: encoder and decoder blocks)
REMAT = [("stablelm-1.6b", {}, 2),
         ("xlstm-1.3b", {}, 2),
         ("zamba2-7b", {"n_layers": 5}, 5),
         ("whisper-large-v3", {}, 4)]


@pytest.mark.parametrize("arch,overrides,n_remat", REMAT,
                         ids=[a for a, _, _ in REMAT])
def test_remat_full_gives_the_gradients_of_none(arch, overrides, n_remat):
    from repro_torch import configs
    from repro_torch.models import init_params, loss_fn, make_batch

    base = configs.reduced(configs.get_config(arch), **overrides)
    model = init_params(base, torch.Generator().manual_seed(1),
                        device="cpu").requires_grad_(True)
    batch = make_batch(base, 2, 24, seed=2, device="cpu")
    weights = list(model.parameters())
    grads = {}
    for remat in ("none", "full"):
        cfg = dataclasses.replace(base, remat=remat)
        with mock.patch.object(transformer, "checkpoint",
                               wraps=transformer.checkpoint) as ck:
            loss, _ = loss_fn(cfg, model, batch)
            grads[remat] = torch.autograd.grad(loss, weights)
        assert ck.call_count == (n_remat if remat == "full" else 0)
        with torch.no_grad(), mock.patch.object(
                transformer, "checkpoint") as ck:
            loss_fn(cfg, model, batch)      # no recomputation to record
        assert ck.call_count == 0
    for a, b in zip(grads["none"], grads["full"]):
        assert torch.equal(a, b)
