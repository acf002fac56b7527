"""The tensor-parallel helpers of ``repro_torch.sharding``, without
processes: which dim of each weight the ``model`` axis shards
(``rules.model_role``) for every configuration, the heads each rank of
the axis computes (``tp.head_plan``), and the vocabulary-parallel cross
entropy against the whole one, its ranks run as threads over a stub of
``all_reduce`` (f32; the losses within 1e-6 relative, the gradients
within 1e-6 of their max-abs: a few f32 ulps, as the two sum their exps in other
orders).  The multi-process paths are in ``test_torch_distributed.py``.
"""

import threading
import types

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.launch.mesh import make_abstract_mesh  # noqa: E402
from repro_torch.models.transformer import param_shapes  # noqa: E402
from repro_torch.sharding import rules, tp  # noqa: E402

AXIS_SIZES = (1, 2, 4, 8, 16)


def _expected_role(name: str, spec: tuple):
    dims = [d for d, e in enumerate(spec) if e == "model"]
    if not dims:
        return None
    if name == "embed" or name.endswith(".embed"):
        return "vocab"
    if dims[0] == len(spec) - 1:
        return "column"
    return "row" if dims[0] == len(spec) - 2 else "expert"


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_model_role_of_every_weight(arch):
    """On the production mesh, in training and inference: the column-
    and row-parallel projections, the vocabulary of the embedding, the
    experts' dim where they divide the axis, and nothing for the norms
    and the weights whose proposal fell back."""
    cfg = configs.get_config(arch)
    shapes = param_shapes(cfg)
    mesh = make_abstract_mesh((16, 16), ("data", "model"))
    for training in (True, False):
        specs = rules.param_specs(cfg, shapes, mesh, training=training)
        for name, spec in specs.items():
            role = rules.model_role(name, spec)
            assert role == _expected_role(name, spec), (name, spec, role)
            leaf = name.rsplit(".", 1)[-1]
            if "norm" in name or leaf in ("scale", "bias"):
                assert role is None, name
            if ".attn." in name or ".xattn." in name:
                assert role == ("row" if leaf == "wo" else "column"), name
            if ".moe." not in name and leaf in (
                    "wu", "wz", "w_in", "w", "w1", "w3", "conv"):
                assert role == "column", name
            if ".moe." not in name and leaf in ("wo", "w_out", "w2"):
                assert role == "row", name
            if name.endswith("lm_head"):
                assert role == "column"
            if ".moe." in name and leaf != "router":
                div = cfg.n_experts % 16 == 0
                assert role == ("expert" if div else
                                "row" if leaf == "w2" else "column"), name


def test_model_role_reads_tuple_entries_and_replicated_specs():
    assert rules.model_role("layers.0.attn.wq", (("pod", "data"), "model")) \
        == "column"
    assert rules.model_role("layers.0.attn.wo", ("model", ("pod", "data"))) \
        == "row"
    assert rules.model_role("layers.0.attn.wq", ("data", None)) is None
    assert rules.model_role("embed", ("model", "data")) == "vocab"
    assert rules.model_role("layers.0.moe.w1", ("model", "data", None)) \
        == "expert"
    assert rules.model_role("layers.0.ln1.scale", ()) is None


def _kv_read(plan, hq: int, hkv: int, i: int) -> int:
    """The key/value head local query head ``i`` reads in the layout the
    attention builds from ``plan``."""
    nq, nkv = plan.q1 - plan.q0, plan.kv1 - plan.kv0
    if plan.kv_index is not None:
        return plan.kv0 + plan.kv_index[i]
    return plan.kv0 + i // (nq // nkv)


@pytest.mark.parametrize("n", AXIS_SIZES)
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_head_plan_covers_the_output_and_reads_each_heads_kv(arch, n):
    """Over the ranks, the output columns are covered once, in order;
    each rank's query heads cover its columns, and each reads the
    key/value head the whole attention gives it (q // group)."""
    cfg = configs.get_config(arch)
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if hq * hd % n:
        pytest.skip(f"{hq * hd} columns do not divide {n}: wo replicated")
    group = hq // hkv
    covered = []
    for i in range(n):
        plan = tp.head_plan(hq, hkv, hd, n, i)
        nq, nkv = plan.q1 - plan.q0, plan.kv1 - plan.kv0
        assert 0 <= plan.c0 < plan.c1 <= nq * hd
        covered += range(plan.q0 * hd + plan.c0, plan.q0 * hd + plan.c1)
        assert plan.kv_index is not None or nq % nkv == 0
        for j in range(nq):
            assert _kv_read(plan, hq, hkv, j) == (plan.q0 + j) // group
    assert covered == list(range(hq * hd))


@pytest.mark.parametrize("shape, rank, want", [
    # codeqwen: 32 heads, 32 key/value heads at 16 ranks: whole groups
    ((32, 32, 128, 16), 3, tp.HeadPlan(6, 8, 6, 8, None, 0, 256)),
    # llava: 8 key/value heads at 16 ranks: one serves both query heads
    ((32, 8, 128, 16), 5, tp.HeadPlan(10, 12, 2, 3, None, 0, 256)),
    # yi: 56 heads at 16 ranks: 3.5 heads a rank, 64 columns in
    ((56, 8, 128, 16), 1, tp.HeadPlan(3, 7, 0, 1, None, 64, 512)),
    # 4 heads over 2 key/value heads at 4 ranks (the tests' GQA case)
    ((4, 2, 16, 4), 3, tp.HeadPlan(3, 4, 1, 2, None, 0, 16)),
    # 6 heads over 3 key/value heads at 4 ranks: a rank straddles groups
    ((6, 3, 4, 4), 1, tp.HeadPlan(1, 3, 0, 2, (0, 1), 2, 8)),
])
def test_head_plan_local_head_counts(shape, rank, want):
    assert tp.head_plan(*shape, rank) == want


class _ThreadAxis:
    """The ranks of one axis as threads: ``all_reduce`` sums (or takes the
    max of) the ranks' tensors, in the same order on each; ``group`` is
    the calling rank."""

    def __init__(self, n: int):
        self.barrier = threading.Barrier(n)
        self.slots = [None] * n

    def all_reduce(self, t, op=dist.ReduceOp.SUM, group=None):
        self.slots[group] = t.detach().clone()
        self.barrier.wait()
        stacked = torch.stack(self.slots)
        out = stacked.amax(0) if op == dist.ReduceOp.MAX else stacked.sum(0)
        self.barrier.wait()
        t.copy_(out)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_vocab_parallel_nll_equals_the_whole_cross_entropy(n, monkeypatch):
    """Logits split over n ranks' vocabulary blocks: every rank's
    per-token loss equals the whole cross entropy, and each rank's
    gradient is its block of the whole gradient; labels at both ends of
    the blocks included."""
    rng = np.random.default_rng(n)
    v, tokens = 32, (3, 7)
    logits = torch.from_numpy(rng.standard_normal((*tokens, v)) * 3.0).float()
    labels = torch.from_numpy(rng.integers(0, v, tokens))
    labels[0, :4] = torch.tensor([0, v - 1, v // n - 1, v // n % v])
    whole = logits.clone().requires_grad_(True)
    want = torch.logsumexp(whole, -1) - torch.gather(
        whole, -1, labels[..., None])[..., 0]
    want.mean().backward()

    axis = _ThreadAxis(n)
    monkeypatch.setattr(tp, "dist", types.SimpleNamespace(
        all_reduce=axis.all_reduce, ReduceOp=dist.ReduceOp))
    got, grads, errors = [None] * n, [None] * n, []

    def rank(i):
        try:
            block = logits.chunk(n, -1)[i].clone().requires_grad_(True)
            nll = tp.vocab_parallel_nll(block, labels, i * (v // n),
                                        tp.TP(n, i, i))
            nll.mean().backward()
            got[i], grads[i] = nll.detach(), block.grad
        except Exception as e:  # surfaced below, with the rank
            errors.append((i, e))
            axis.barrier.abort()

    threads = [threading.Thread(target=rank, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and not any(t.is_alive() for t in threads), errors
    for i in range(n):
        np.testing.assert_allclose(got[i].numpy(), want.detach().numpy(),
                                   rtol=1e-6)
        block = whole.grad.chunk(n, -1)[i]
        assert float((grads[i] - block).abs().max()) <= 1e-6 * float(
            whole.grad.abs().max())
