"""The port's vlm, audio, moe, ssm and hybrid families against the JAX
package's.

Reduced configs of llava-next-mistral-7b (vlm), whisper-large-v3
(audio), qwen3-moe-235b-a22b (moe), xlstm-1.3b (ssm: 2 superblocks of one
mLSTM and one sLSTM block) and zamba2-7b (hybrid, at 5 layers: 2
superblocks of 2 Mamba2 blocks, each followed by the shared attention
block, and a tail of 1), with the reference's weights carried across by
``params_from_jax`` and inputs from the same seeded numpy draws
(``make_batch``).  24 positions are one whole chunk of 16 and a padded
one for the SSM mixers.  Both packages run in f32 on the CPU, with
``attention_impl="reference"`` and ``"pallas"`` (JAX's flash kernel in
interpret mode, the port's plain version).  Logits agree within 1e-4
(the two sum in different orders), greedy tokens are equal, and the moe
routing (which choices are kept, and their slots) is equal exactly."""

import dataclasses
import functools
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import io as jax_io  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro.serving import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402
from repro_torch.models import (  # noqa: E402
    XLSTMLM, DenseLM, EncDecLM, ZambaLM, attention, decode_step, fill_cache,
    forward, init_cache, init_params, make_batch, moe, params_from_jax,
    prefill,
)
from repro_torch.serving import ServeConfig, ServingEngine  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
VLM, AUDIO, MOE = ("llava-next-mistral-7b", "whisper-large-v3",
                   "qwen3-moe-235b-a22b")
XLSTM, ZAMBA = "xlstm-1.3b", "zamba2-7b"
ARCHS = [VLM, AUDIO, MOE, XLSTM, ZAMBA]
#: zamba2 at 5 layers: the reduced default's 4 (attn_every 2) leave the
#: Mamba2 tail empty
ARCH_OVERRIDES = {ZAMBA: {"n_layers": 5}}
IMPLS = ["reference", "pallas"]
#: the cell of each test: 2 rows of 24 positions (vlm: 8 patches + 16
#: tokens), 8 new tokens
BATCH, SEQ, NEW = 2, 24, 8


def close(got: torch.Tensor, want, **tol) -> None:
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def cfg_pair(arch: str, **overrides):
    overrides = {**ARCH_OVERRIDES.get(arch, {}), **overrides}
    return (jax_configs.reduced(jax_configs.get_config(arch), **overrides),
            configs.reduced(configs.get_config(arch), **overrides))


@functools.cache
def models(arch: str, impl: str):
    """(jax cfg, jax params, port cfg, port model) with equal weights."""
    jcfg, tcfg = cfg_pair(arch, attention_impl=impl)
    params = jax_tf.init_params(jcfg, jax.random.key(3))
    model = params_from_jax(
        tcfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return jcfg, params, tcfg, model


def batches(jcfg, tcfg, seed: int = 5):
    """The same batch for both packages, from one seed."""
    jb = jax_io.make_batch(jcfg, BATCH, SEQ, seed=seed)
    tb = make_batch(tcfg, BATCH, SEQ, seed=seed, device="cpu")
    return jb, tb


def max_len(tcfg) -> int:
    return SEQ + NEW if tcfg.family != "vlm" else SEQ + NEW + 8


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch, impl):
    jcfg, params, tcfg, model = models(arch, impl)
    jb, tb = batches(jcfg, tcfg)
    before = dict(ops.counts)
    want = np.asarray(jax_tf.forward(jcfg, params, jb))
    got = forward(tcfg, model, tb)
    assert ops.counts == before           # the CPU path launches nothing
    positions = SEQ if arch != AUDIO else tb["tokens"].shape[1]
    assert got.shape == (BATCH, positions, tcfg.vocab_size)
    close(got, want)
    close(forward(tcfg, model, tb, last_only=True), want[:, -1:])


def jax_greedy(jcfg, params, batch, n: int, length: int):
    logits, cache = jax_tf.prefill(jcfg, params, batch, length)
    step = jax.jit(lambda c, t: jax_tf.decode_step(jcfg, params, c, t))
    toks, all_logits = [], [np.asarray(logits)]
    for _ in range(n):
        tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(tok))
        logits, cache = step(cache, tok)
        all_logits.append(np.asarray(logits))
    return np.concatenate(toks, axis=1), all_logits


def port_greedy(tcfg, model, batch, n: int, length: int):
    logits, cache = prefill(tcfg, model, batch, length)
    toks, all_logits = [], [logits]
    for _ in range(n):
        tok = torch.argmax(logits[:, -1, :], dim=-1, keepdim=True)
        toks.append(tok)
        logits, cache = decode_step(tcfg, model, cache, tok)
        all_logits.append(logits)
    return torch.cat(toks, dim=1).numpy(), all_logits


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_prefill_and_decode_match_jax(arch, impl):
    """``prefill`` then ``NEW`` greedy ``decode_step``s, the reference's
    serving entry points for these families: equal tokens, and the logits
    of every step within 1e-4."""
    jcfg, params, tcfg, model = models(arch, impl)
    jb, tb = batches(jcfg, tcfg, seed=6)
    want, want_logits = jax_greedy(jcfg, params, jb, NEW, max_len(tcfg))
    got, got_logits = port_greedy(tcfg, model, tb, NEW, max_len(tcfg))
    np.testing.assert_array_equal(got, want)
    for g, w in zip(got_logits, want_logits):
        close(g, w)


def test_moe_serving_engine_equals_jax_engine():
    """The moe family takes tokens only, so both ``ServingEngine``s serve
    it: the same greedy tokens."""
    jcfg, params, tcfg, model = models(MOE, "pallas")
    p = np.random.default_rng(7).integers(
        0, tcfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    want = JaxServingEngine(jcfg, params, JaxServeConfig(
        max_len=SEQ + NEW)).generate(p, NEW)
    got = ServingEngine(tcfg, model, ServeConfig(max_len=SEQ + NEW),
                        device="cpu").generate(p, NEW)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("arch", [XLSTM, ZAMBA])
def test_ssm_and_hybrid_serving_engine_equals_jax_engine(arch):
    """xlstm and zamba2 take tokens only, so both ``ServingEngine``s
    serve them: the same greedy tokens (zamba2's prefill attention on the
    flash function)."""
    jcfg, params, tcfg, model = models(arch, "pallas")
    p = np.random.default_rng(9).integers(
        0, tcfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    want = JaxServingEngine(jcfg, params, JaxServeConfig(
        max_len=SEQ + NEW)).generate(p, NEW)
    before = ref.counts["flash_attention"]
    got = ServingEngine(tcfg, model, ServeConfig(max_len=SEQ + NEW),
                        device="cpu").generate(p, NEW)
    np.testing.assert_array_equal(got, np.asarray(want))
    shared_uses = tcfg.n_layers // tcfg.attn_every if arch == ZAMBA else 0
    assert ref.counts["flash_attention"] == before + shared_uses


@pytest.mark.parametrize("impl", IMPLS)
def test_vlm_prefill_counts_the_patches(impl):
    """The vlm cache holds the patch prefix: ``pos`` after prefill is
    patches + tokens, as the reference's, and the filled k/v agree."""
    jcfg, params, tcfg, model = models(VLM, impl)
    jb, tb = batches(jcfg, tcfg)
    _, want = jax_tf.prefill(jcfg, params, jb, max_len(tcfg))
    _, got = prefill(tcfg, model, tb, max_len(tcfg))
    assert got["pos"] == int(want["pos"]) == SEQ     # 8 patches + 16 tokens
    close(got["k"], want["k"])
    close(got["v"], want["v"])
    cache = fill_cache(tcfg, model, tb, init_cache(
        tcfg, BATCH, max_len(tcfg), device="cpu"))
    assert torch.equal(cache["k"], got["k"]) and cache["pos"] == got["pos"]


@pytest.mark.parametrize("impl", IMPLS)
def test_whisper_prefill_leaves_the_caches_zero_like_the_reference(impl):
    """The reference's ``fill_cache`` sets only ``pos`` for audio, so
    after ``prefill`` the self-attention cache (k, v) and the
    cross-attention cache (xk, xv) are zero.  The port reproduces it (a
    fault of the reference, kept for parity).  Smallest input: a 2-token
    prompt."""
    jcfg, params, tcfg, model = models(AUDIO, impl)
    jb = jax_io.make_batch(jcfg, 1, 2, seed=8)
    tb = make_batch(tcfg, 1, 2, seed=8, device="cpu")
    _, want = jax_tf.prefill(jcfg, params, jb, 8)
    _, got = prefill(tcfg, model, tb, 8)
    assert sorted(got) == sorted(want) == ["k", "pos", "v", "xk", "xv"]
    assert got["pos"] == int(want["pos"]) == 2
    for name in ("k", "v", "xk", "xv"):
        assert tuple(got[name].shape) == want[name].shape
        assert not got[name].any() and not np.asarray(want[name]).any()
    assert got["xk"].shape[2] == tcfg.encoder_seq


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", [XLSTM, ZAMBA])
def test_ssm_and_hybrid_prefill_leave_the_states_zero_like_the_reference(
        arch, impl):
    """The reference's ``fill_cache`` sets only ``pos`` for ssm and
    hybrid too, so after ``prefill`` the mLSTM and sLSTM states (xlstm)
    and the Mamba2 states, conv windows and shared attention's KV cache
    (zamba2) are zero.  The port reproduces it (a fault of the reference,
    kept for parity).  Smallest input: a 2-token prompt."""
    jcfg, params, tcfg, model = models(arch, impl)
    jb = jax_io.make_batch(jcfg, 1, 2, seed=8)
    tb = make_batch(tcfg, 1, 2, seed=8, device="cpu")
    want_logits, want = jax_tf.prefill(jcfg, params, jb, 8)
    got_logits, got = prefill(tcfg, model, tb, 8)
    close(got_logits, want_logits)
    names = (["m", "pos", "s_c", "s_h", "s_n"] if arch == XLSTM else
             ["conv", "conv_tail", "k", "m", "m_tail", "pos", "v"])
    assert sorted(got) == sorted(want) == names
    assert got["pos"] == int(want["pos"]) == 2
    for name in names:
        if name != "pos":
            assert tuple(got[name].shape) == want[name].shape
            assert got[name].dtype == getattr(torch, want[name].dtype.name)
            assert not got[name].any() and not np.asarray(want[name]).any()
    if arch == ZAMBA:
        assert got["m_tail"].shape[0] == 1


def test_port_classes_and_cache_layouts():
    for arch, cls in ((VLM, DenseLM), (MOE, DenseLM), (AUDIO, EncDecLM),
                      (XLSTM, XLSTMLM), (ZAMBA, ZambaLM)):
        jcfg, _, tcfg, model = models(arch, "reference")
        assert isinstance(model, cls)
        want = jax_tf.init_cache(jcfg, BATCH, 12)
        got = init_cache(tcfg, BATCH, 12, device="cpu")
        assert sorted(got) == sorted(want)
        for name in got:
            if name != "pos":
                assert tuple(got[name].shape) == want[name].shape


#: the reference's stacked trees -> their number of stacked leading axes
STACKED = {"layers": 1, "encoder": 1, "decoder": 1, "sblocks": 1,
           "mamba_tail": 1, "mblocks": 2, "mamba_sb": 2}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_shapes_match_the_reference(arch):
    jcfg, tcfg = cfg_pair(arch, dtype="bfloat16")
    model = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    shapes = jax_tf.param_shapes(jcfg)
    mine = dict(model.named_parameters())
    n = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = [k.key for k in path]
        # the reference's stacked axes are the port's module indices
        depth = STACKED.get(keys[0], 0)
        for index in np.ndindex(*leaf.shape[:depth]):
            name = ".".join([keys[0], *map(str, index), *keys[1:]])
            p = mine[name]
            assert tuple(p.shape) == leaf.shape[depth:], name
            assert p.dtype == getattr(torch, leaf.dtype.name), name
            n += 1
    assert n == len(mine)


def test_params_from_jax_keeps_the_expert_layout_and_router_dtype():
    jcfg, tcfg = cfg_pair(MOE, dtype="bfloat16")
    params = jax_tf.init_params(jcfg, jax.random.key(1))
    model = params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, params),
                            device="cpu")
    got = model.layers[1].moe
    assert got["router"].dtype == torch.float32
    assert got["w1"].dtype == torch.bfloat16
    assert tuple(got["w2"].shape) == (tcfg.n_experts, tcfg.d_ff,
                                      tcfg.d_model)
    np.testing.assert_array_equal(
        got["w3"].float().numpy(),
        np.asarray(params["layers"]["moe"]["w3"][1], np.float32))
    assert model.layers[0].mlp is None


def _moe_weights(jcfg, seed: int):
    p = jax_moe.moe_init(jax.random.key(seed), jcfg, jnp.float32)
    return p, {k: torch.from_numpy(np.array(a)) for k, a in p.items()}


@pytest.mark.parametrize("capacity", [None, 1, 3])
def test_moe_apply_matches_jax(capacity):
    """Within 1e-5, at the default capacity (1.25 x the mean load) and at
    capacities that drop most choices."""
    jcfg, tcfg = cfg_pair(MOE)
    jp, tp = _moe_weights(jcfg, 11)
    x = np.random.default_rng(12).standard_normal(
        (2, 24, tcfg.d_model)).astype(np.float32)
    want = jax_moe.moe_apply(jp, jcfg, jnp.asarray(x), capacity)
    got = moe.moe_apply(tp, tcfg, torch.from_numpy(x), capacity)
    close(got, want, rtol=1e-5, atol=1e-5)


class _RecordWhere:
    """Stands in for ``jnp`` inside the reference's moe module and keeps
    what its ``jnp.where`` computes: the kept mask and the slots."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def where(self, cond, *args):
        out = jnp.where(cond, *args)
        self.calls.append((np.asarray(cond), np.asarray(out)))
        return out


@pytest.mark.parametrize("capacity", [1, 2])
def test_moe_keep_and_slots_equal_the_reference_where_capacity_drops(
        capacity):
    """The stable sort's position-in-expert decides which choices are
    kept; with a capacity of 1 or 2 most are dropped into the bucket row.
    The port's keep mask and slots equal the reference's exactly."""
    jcfg, tcfg = cfg_pair(MOE)
    jp, tp = _moe_weights(jcfg, 13)
    x = np.random.default_rng(14).standard_normal(
        (2, 24, tcfg.d_model)).astype(np.float32)
    rec = _RecordWhere()
    with mock.patch.object(jax_moe, "jnp", rec):
        jax_moe.moe_apply(jp, jcfg, jnp.asarray(x), capacity)
    (want_keep, want_slot), = rec.calls
    _, _, keep, slot = moe.moe_route(tp, tcfg, torch.from_numpy(x), capacity)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    np.testing.assert_array_equal(slot.numpy(), want_slot)
    assert 0 < keep.sum() < keep.numel()                 # drops happened
    assert (slot[~keep] == tcfg.n_experts * capacity).all()


def test_moe_capacity_matches_the_reference():
    jcfg, tcfg = cfg_pair(MOE)
    full_j = jax_configs.get_config(MOE)
    full_t = configs.get_config(MOE)
    for s in (1, 24, 2048):
        assert moe.moe_capacity(tcfg, s) == jax_moe.moe_capacity(jcfg, s)
        assert moe.moe_capacity(full_t, s) == jax_moe.moe_capacity(full_j, s)


@pytest.mark.parametrize("policy", ["ep", "ep_infer"])
def test_moe_expert_parallel_path_is_not_ported(policy):
    """With an expert-parallel policy and no mesh set, ``moe_apply`` runs
    the plain dispatch, as the reference's does (the reference's "ep"
    constraint needs a mesh in context, which is not the mesh of
    ``set_mesh``); within ``TOL``.  The all-to-all path itself is held
    to the reference's in ``tests/test_torch_distributed.py``."""
    from repro.launch.mesh import make_local_mesh

    jcfg, tcfg = cfg_pair(MOE, moe_shard=policy)
    jp, tp = _moe_weights(jcfg, 0)
    x = np.random.default_rng(3).standard_normal(
        (2, 24, tcfg.d_model)).astype(np.float32)
    assert jax_moe._MESH is None and moe._MESH is None
    with make_local_mesh(1, 1):
        want = jax_moe.moe_apply(jp, jcfg, jnp.asarray(x))
    got = moe.moe_apply(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_chip_smoke_holds_routing_flips_to_near_ties():
    """``chip_smoke.rerouted_rows`` (the card's f32 moe check): a token
    may change experts between two paths only where its k-th and
    (k+1)-th gates nearly tie; the rows where one did are named."""
    import chip_smoke

    experts = torch.tensor([[[0, 1], [2, 3]], [[0, 2], [1, 3]]])
    keep = torch.ones((2, 2, 2), dtype=torch.bool)
    gap = torch.full((2, 2), 1e-3)
    moved = experts.clone()
    moved[1, 0] = torch.tensor([0, 3])
    near = gap.clone()
    near[1, 0] = 1e-7
    rows, flips = chip_smoke.rerouted_rows(
        torch, [(experts, keep, near)], [(moved, keep, near)], "moe")
    assert rows.tolist() == [False, True] and flips == 1
    with pytest.raises(AssertionError, match="near tie"):
        chip_smoke.rerouted_rows(torch, [(experts, keep, gap)],
                                 [(moved, keep, gap)], "moe")
    dropped = keep.clone()
    dropped[0, 1, 0] = False
    with pytest.raises(AssertionError, match="kept choices"):
        chip_smoke.rerouted_rows(torch, [(experts, keep, gap)],
                                 [(experts, dropped, gap)], "moe")


def test_chip_smoke_routing_recorder_records_moe_route():
    """``chip_smoke.RoutingRecorder`` routes as ``moe_route`` and records,
    for each call, each token's experts in order, their kept mask and the
    gap between its k-th and (k+1)-th gates."""
    import chip_smoke

    jcfg, tcfg = cfg_pair(MOE)
    _, tp = _moe_weights(jcfg, 17)
    x = torch.from_numpy(np.random.default_rng(18).standard_normal(
        (2, 24, tcfg.d_model)).astype(np.float32))
    rec = chip_smoke.RoutingRecorder(torch, moe)
    with mock.patch.object(moe, "moe_route", rec):
        got = moe.moe_apply(tp, tcfg, x)
    assert torch.equal(got, moe.moe_apply(tp, tcfg, x))
    k = tcfg.experts_per_token
    _, ef, keep, _ = moe.moe_route(tp, tcfg, x, moe.moe_capacity(tcfg, 24))
    (experts, kept, gap), = rec.calls
    want, order = ef.reshape(2, 24, k).sort(dim=-1)
    assert torch.equal(experts, want)
    assert torch.equal(kept, torch.gather(keep.reshape(2, 24, k), -1, order))
    top = torch.topk(torch.softmax(x @ tp["router"], dim=-1), k + 1).values
    assert torch.equal(gap, top[..., k - 1] - top[..., k])
    assert bool((gap >= 0).all())


def _attn_weights(rng, cfg):
    d, hd = cfg.d_model, cfg.head_dim
    shapes = {"wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
              "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d)}
    return {n: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
            for n, s in shapes.items()}


@pytest.mark.parametrize("use_rope", [False, True])
@pytest.mark.parametrize("impl", IMPLS)
def test_cross_attention_matches_jax(impl, use_rope):
    """k/v from ``kv_x`` (Lk 40 against Lq 24), non-causal; with RoPE the
    keys take positions ``arange(Lk)``.  The pallas path launches the
    flash function on Lq != Lk."""
    jcfg, tcfg = cfg_pair(AUDIO, attention_impl=impl)
    rng = np.random.default_rng(15)
    w = _attn_weights(rng, tcfg)
    x = rng.standard_normal((2, 24, tcfg.d_model)).astype(np.float32)
    kv_x = rng.standard_normal((2, 40, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24)).copy()
    before = ref.counts["flash_attention"]
    got, (gk, gv) = attention.attention(
        {k: torch.from_numpy(a) for k, a in w.items()}, tcfg,
        torch.from_numpy(x), torch.from_numpy(pos), causal=False,
        kv_x=torch.from_numpy(kv_x), use_rope=use_rope)
    assert ref.counts["flash_attention"] == before + (impl == "pallas")
    want, (wk, wv) = jax_attn.attention(
        {k: jnp.asarray(a) for k, a in w.items()}, jcfg, jnp.asarray(x),
        jnp.asarray(pos), causal=False, kv_x=jnp.asarray(kv_x),
        use_rope=use_rope)
    assert tuple(gk.shape) == (2, 40, tcfg.n_kv_heads, tcfg.head_dim)
    close(got, want)
    close(gk, wk)
    close(gv, wv)


@pytest.mark.parametrize("use_rope", [False, True])
def test_decode_attention_with_and_without_rope(use_rope):
    jcfg, tcfg = cfg_pair(AUDIO)
    rng = np.random.default_rng(16)
    w = _attn_weights(rng, tcfg)
    x = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
    shape = (2, 12, tcfg.n_kv_heads, tcfg.head_dim)
    kc, vc = (rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))
    got, gk, gv = attention.decode_attention(
        {k: torch.from_numpy(a) for k, a in w.items()}, tcfg,
        torch.from_numpy(x), torch.from_numpy(kc.copy()),
        torch.from_numpy(vc.copy()), 7, use_rope=use_rope)
    want, wk, wv = jax_attn.decode_attention(
        {k: jnp.asarray(a) for k, a in w.items()}, jcfg, jnp.asarray(x),
        jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(7, jnp.int32),
        use_rope=use_rope)
    close(got, want)
    close(gk, wk)
    close(gv, wv)


def test_attn_init_takes_d_in():
    _, tcfg = cfg_pair(AUDIO)
    p = attention.attn_init(torch.Generator().manual_seed(0), tcfg,
                            torch.float32, d_in=48)
    assert tuple(p["wq"].shape) == (48, tcfg.n_heads * tcfg.head_dim)
    assert tuple(p["wo"].shape) == (tcfg.n_heads * tcfg.head_dim, 48)
    want = jax_attn.attn_init(jax.random.key(0), cfg_pair(AUDIO)[0],
                              jnp.float32, d_in=48)
    assert {k: tuple(v.shape) for k, v in p.named_parameters()} == {
        k: v.shape for k, v in want.items()}


def test_vlm_batch_carries_the_patches_in_the_model_dtype():
    """Patches are cast to the model's dtype and go before the tokens; a
    bf16 model gets bf16 patches whatever the batch holds."""
    _, tcfg = cfg_pair(VLM, dtype="bfloat16")
    model = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    tb = make_batch(dataclasses.replace(tcfg, dtype="float32"), 1, SEQ,
                    seed=1, device="cpu")
    assert tb["patches"].dtype == torch.float32
    logits = forward(tcfg, model, tb)
    assert logits.dtype == torch.bfloat16
    assert logits.shape == (1, SEQ, tcfg.vocab_size)
    assert bool(torch.isfinite(logits.float()).all())
