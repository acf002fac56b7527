"""The check that decides ``correct``, driven end to end on the CPU.

Each tiny cell (``cardbench_tiny``) runs as the benchmark runs it, with
the look for a card skipped: set-up, window, release, the reference's
judgement.  A sound program comes out correct; with the timed path
broken underneath in each way the cell can be broken, it does not.  (One
card: no exchange between chips to leave out.)"""

from __future__ import annotations

import pytest
import torch

import cardbench_tiny as tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.build(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_sound_program_comes_out_correct(root, cell):
    result, lines = tiny.run(root, cell)
    assert result["correct"], lines
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "compared"
    assert set(result["compared"]) == set(tiny.CELLS[cell][3])
    assert lines[-len(result["compared"]):] == [
        f"compared {k}: {v['value']!r} limit {v['limit']!r}"
        for k, v in result["compared"].items()]


@pytest.mark.parametrize("cell", ["tiny.prefill", "tiny.decode"])
def test_token_altered_where_produced_is_not_correct(root, cell,
                                                     monkeypatch):
    from repro_torch.serving.engine import ServingEngine

    sample = ServingEngine._sample

    def altered(self, logits, gen):
        return (sample(self, logits, gen) + 1) % logits.shape[-1]

    monkeypatch.setattr(ServingEngine, "_sample", altered)
    result, _ = tiny.run(root, cell)
    assert not result["correct"]
    gap = "first_token_gap" if cell == "tiny.prefill" else "decode_token_gap"
    assert result["compared"][gap]["value"] > result["compared"][gap]["limit"]


def test_step_that_leaves_its_state_unchanged_is_not_correct(root,
                                                             monkeypatch):
    from repro_torch.training import train_step as ts

    def unchanged(cfg, params, grads, opt):
        zero = torch.zeros(())
        return params, opt, {"grad_norm": zero, "lr": zero}

    monkeypatch.setattr(ts, "adamw_update", unchanged)
    result, _ = tiny.run(root, "tiny.train")
    assert not result["correct"]
    assert result["compared"]["change_gap"]["value"] == pytest.approx(1.0)
    assert result["compared"]["first_grad_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out_is_not_correct(root, monkeypatch):
    import repro_torch.training as training

    make_steps = training.make_steps

    def halved(*args, **kwargs):
        steps = make_steps(*args, **kwargs)
        step = steps["train_step"]
        steps["train_step"] = lambda model, opt, batch: step(
            model, opt, {k: v[: len(v) // 2] for k, v in batch.items()})
        return steps

    monkeypatch.setattr(training, "make_steps", halved)
    result, _ = tiny.run(root, "tiny.train")
    assert not result["correct"]
    c = result["compared"]["first_grad_gap"]
    assert c["value"] > c["limit"]
