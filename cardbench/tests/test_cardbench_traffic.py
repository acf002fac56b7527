"""The traffic's schedules, and inputs and weights drawn from the seed."""

from __future__ import annotations

import json
import math

import pytest
import torch

import cardbench_tiny as tiny
from cardbench import checks, weights

HERE = tiny.ROOT / "cardbench"
BIG_SEEDS = (0, 2 ** 31 + 7, 10 ** 12 + 3)


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def test_prefill_pool_cycle():
    t, cfg = traffic("prefill_pool"), config("deepseek-llm-7b")
    batches = [(b["rows"], b["length"]) for b in t["batches"]]
    rows = sorted(length for n, length in batches for _ in range(n))
    assert len(rows) == 80
    # the median prompt near the code trace's 1,500 tokens, none past the
    # model's context, no batch past 16,384 tokens
    assert rows[39] == rows[40] == 1536
    assert max(rows) == cfg["max_position_embeddings"] == 4096
    assert max(n * length for n, length in batches) == 16384
    # the longest prompts are the top tenth of rows, so the nearest-rank
    # 95th percentile of whole cycles falls among them whatever the number
    # of cycles
    assert rows[72:] == [4096] * 8 and rows[71] < 4096
    for cycles in range(1, 40):
        n = 80 * cycles
        assert math.ceil(0.95 * n) - 1 >= n - 8 * cycles
    # the check's sample: one of the longest and 192 of the shortest
    assert t["check_rows"] == 193


def test_prefill_window_ends_on_whole_cycles():
    import types

    from cardbench.drivers import prefill_pool as pool

    served = []
    run = types.SimpleNamespace(
        traffic={"batches": [{"rows": 2, "length": 8},
                             {"rows": 1, "length": 16}]},
        cfg={"vocab_size": 10})
    st = {"batches": [], "kept": []}

    def batch(run, st, index, shape, keep):
        served.append(shape)
        st["batches"].append((shape[0], shape[1], 0.001 * index))

    pool._batch, saved = batch, pool._batch
    try:
        out = pool.measure(run, st, 0.0)
    finally:
        pool._batch = saved
    assert served == [(2, 8), (1, 16)]
    assert out["counters"]["batches"] == 2 and out["attempted"] == 3


def test_decode_batch_fits_the_card():
    t, cfg = traffic("decode_batch"), config("deepseek-llm-7b")
    assert (t["rows"], t["prompt"], t["new_tokens"]) == (64, 1024, 128)
    cache = (2 * cfg["n_layers"] * t["rows"] * (t["prompt"] + t["new_tokens"])
             * cfg["n_kv_heads"] * cfg["head_dim"] * 2)
    assert cache == pytest.approx(36.24e9, rel=1e-3)
    assert cache + 2 * 6.91e9 < 80e9


def test_train_steps_are_the_cut_of_train_4k():
    t = traffic("train_2k")
    assert (t["batch"], t["seq"]) == (4, 2048)
    assert t["cut_from"] == {"batch": 256, "seq": 4096}
    assert t["checked_steps"] == 3


@pytest.mark.parametrize("seed", BIG_SEEDS)
def test_tokens_are_the_seeds(seed):
    a = weights.make_tokens(seed, 3, 4, 50, 1000, "cpu")
    assert torch.equal(a, weights.make_tokens(seed, 3, 4, 50, 1000, "cpu"))
    assert a.dtype == torch.int64 and int(a.min()) >= 0 and \
        int(a.max()) < 1000
    assert not torch.equal(a, weights.make_tokens(seed + 1, 3, 4, 50, 1000,
                                                  "cpu"))
    assert not torch.equal(a, weights.make_tokens(seed, 4, 4, 50, 1000,
                                                  "cpu"))


def test_group_seeds_fit_a_generator():
    for seed in BIG_SEEDS:
        for index in (0, 1, 2 ** 20, 2 ** 40):
            g = weights.group_seed(seed, index)
            assert 0 <= g < 2 ** 63
            torch.Generator().manual_seed(g)


def test_weights_are_the_seeds_and_a_block_is_made_again_alone():
    cfg = dict(config("deepseek-llm-7b"), **dict(tiny.TINY,
                                                 norm="layernorm"))
    a = weights.make_weights(cfg, 2 ** 31 + 1, "cpu")
    b = weights.make_weights(cfg, 2 ** 31 + 1, "cpu")
    assert torch.equal(a["embed"], b["embed"])
    assert torch.equal(a["lm_head"], b["lm_head"])
    block = weights.make_block(cfg, 2 ** 31 + 1, 1, "cpu")
    for name in weights.BLOCK_MATRICES:
        assert torch.equal(a["layers"][1][name], block[name])
        assert a["layers"][1][name].dtype == torch.bfloat16
    assert not torch.equal(a["layers"][0]["wq"], a["layers"][1]["wq"])
    assert a["layers"][0]["ln1"]["scale"].dtype == torch.float32
    assert torch.equal(a["layers"][0]["ln1"]["bias"], torch.zeros(64))
    c = weights.make_weights(cfg, 2 ** 31 + 2, "cpu")
    assert not torch.equal(a["embed"], c["embed"])


def test_weights_scale_by_fan_in():
    cfg = dict(config("deepseek-llm-7b"), **dict(tiny.TINY, d_model=256,
                                                d_ff=1024))
    w = weights.make_weights(cfg, 5, "cpu")
    assert float(w["layers"][0]["w2"].float().std()) == pytest.approx(
        1024 ** -0.5, rel=0.05)
    assert float(w["embed"].float().std()) == pytest.approx(0.02, rel=0.05)
    assert "bias" not in w["final_norm"]


def test_digest_positions_hold_the_last():
    for length in (1, 3, 1024):
        pos = checks.digest_positions(9, 2, length, 4)
        assert pos == sorted(set(pos)) and pos[-1] == length - 1
        assert len(pos) == min(4, length)
        assert pos == checks.digest_positions(9, 2, length, 4)


def test_the_sample_holds_a_longest_request():
    rows = [{"length": n, "i": i} for i, n in
            enumerate([512] * 32 + [2048] * 16 + [4096] * 3)]
    for seed in BIG_SEEDS:
        picked = checks.sample_rows(seed, rows, 12)
        assert len(picked) == 12 and len({r["i"] for r in picked}) == 12
        assert sorted(r["length"] for r in picked) == [512] * 11 + [4096]
        assert picked == checks.sample_rows(seed, rows, 12)
    assert checks.sample_rows(1, rows, 12) != checks.sample_rows(2, rows, 12)
    assert len(checks.sample_rows(1, rows, 40)) == 33
    same = [{"length": 7, "i": i} for i in range(5)]
    assert len(checks.sample_rows(1, same, 12)) == 5
