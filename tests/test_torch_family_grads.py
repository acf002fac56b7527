"""Loss and gradients of the port's ``loss_fn`` against
``jax.value_and_grad`` of the JAX package's, for every architecture.

Each ``ARCH_ID`` at its reduced config (zamba2 at 5 layers, so its
Mamba2 tail is not empty), f32 on the CPU, ``attention_impl="reference"``
(every config's default), the reference's weights carried across with
``params_from_jax`` and a batch from ``make_batch``'s seeded draws.  The
reference's gradient tree has its params' structure, so
``params_from_jax`` carries it across too, and the two are compared by
parameter name.  The loss agrees within 1e-5; each gradient within 1e-4
of its tensor's max-abs (the worst seen, zamba2's, is 3.6e-5: the two
sum in other orders, and the chunked scans of the ssm and hybrid mixers
longest).  No parameter is left without a gradient
(``torch.autograd.grad`` raises on an unused one)."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import io as jax_io  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import loss_fn, make_batch, params_from_jax  # noqa: E402

LOSS_RTOL, GRAD_REL = 1e-5, 1e-4
#: zamba2 at 5 layers: the reduced default's 4 (attn_every 2) leave the
#: Mamba2 tail empty
ARCH_OVERRIDES = {"zamba2-7b": {"n_layers": 5}}
BATCH, SEQ = 2, 24


def cfg_pair(arch: str, **overrides):
    overrides = {**ARCH_OVERRIDES.get(arch, {}), **overrides}
    return (jax_configs.reduced(jax_configs.get_config(arch), **overrides),
            configs.reduced(configs.get_config(arch), **overrides))


@functools.cache
def reference(arch: str, **overrides):
    """(jax cfg, port cfg, params as numpy, jax loss, jax grads as numpy,
    the port's batch) on the same seeded weights and batch."""
    jcfg, tcfg = cfg_pair(arch, **overrides)
    params = jax_tf.init_params(jcfg, jax.random.key(3))
    jb = jax_io.make_batch(jcfg, BATCH, SEQ, seed=5)
    (loss, _), grads = jax.value_and_grad(
        lambda p: jax_tf.loss_fn(jcfg, p, jb), has_aux=True)(params)
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    tb = make_batch(tcfg, BATCH, SEQ, seed=5, device="cpu")
    return jcfg, tcfg, to_np(params), float(loss), to_np(grads), tb


def port_loss_and_grads(tcfg, params: dict, batch: dict):
    model = params_from_jax(tcfg, params, device="cpu").requires_grad_(True)
    named = dict(model.named_parameters())
    loss, metrics = loss_fn(tcfg, model, batch)
    assert float(metrics["perplexity"].detach()) == pytest.approx(
        float(torch.exp(loss.detach())))
    grads = torch.autograd.grad(loss, list(named.values()))
    return float(loss.detach()), dict(zip(named, grads))


def assert_grads_match(tcfg, got: dict, want_tree: dict) -> None:
    want = dict(params_from_jax(tcfg, want_tree,
                                device="cpu").named_parameters())
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        w = want[name].numpy()
        err = float(np.abs(g.numpy() - w).max())
        assert err <= GRAD_REL * float(np.abs(w).max()), (name, err)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_loss_and_grads_match_jax(arch):
    _, tcfg, params, want_loss, want_grads, tb = reference(arch)
    loss, grads = port_loss_and_grads(tcfg, params, tb)
    assert loss == pytest.approx(want_loss, rel=LOSS_RTOL)
    assert_grads_match(tcfg, grads, want_grads)
