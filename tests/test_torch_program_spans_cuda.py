"""The port's spans on the card's clock: in one traced decode step of a
small dense model, the device operations meet the runtime calls that
launched them (``tools/program_spans.py``), and the device's records sit
on the host's clock within the profiler's alignment.  That alignment is
not exact: on an H100 with torch 2.11 a capture's device records lay
from 0.93 ms before their launches to in order, the offset drawn anew
with each profiler session (the share in order is printed).  What the
view reads by launch (device time and launches under a range) compares
host times only; idle under a range compares the device's gaps with the
host's ranges, and takes the offset.  Marked ``cuda``; a few seconds on
an H100:

    PYTHONPATH=src python -m pytest -q -s -m cuda \\
        tests/test_torch_program_spans_cuda.py
"""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

#: how far before its launch the profiler may place a device record
#: (0.93 ms the worst of 14 captures)
ALIGNMENT_US = 5000.0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def test_a_decode_steps_operations_meet_their_launches(card):
    from torch.profiler import ProfilerActivity, profile

    from cardbench import trace
    from repro_torch import configs
    from repro_torch.models import decode_step, init_params, prefill
    from tools.program_spans import Program

    cfg = configs.reduced(configs.get_config("codeqwen1.5-7b"),
                          n_layers=4, d_model=512, n_heads=8, n_kv_heads=8,
                          head_dim=64, d_ff=1024, dtype="bfloat16",
                          attention_impl="pallas")
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (4, 128), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(1))
    logits, cache = prefill(cfg, model, {"tokens": tokens}, 136)
    step = logits[:, -1:].argmax(-1)
    decode_step(cfg, model, cache, step)       # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with trace.span("traced"):
            decode_step(cfg, model, cache, step)
            torch.cuda.synchronize()
    p = Program(prof.profiler.kineto_results.events())
    assert p.count("decode_step") == 1
    assert p.count("attend") == p.count("rope") == cfg.n_layers
    assert p.count("norm") == 2 * cfg.n_layers
    matched = p.launch == p.launch              # not NaN
    after = p.start[matched] - p.launch[matched]
    print(f"device operations {len(p.launch)}, matched "
          f"{matched.mean():.6f}, in order {(after >= 0).mean():.6f}, start "
          f"after launch {after.min():.2f} to {after.max():.2f} us, under "
          f"decode_step {p.launches('decode_step')}, under attend "
          f"{p.launches('attend', within='decode_step')}")
    assert matched.mean() >= 0.99
    # one clock, to within the alignment (a clock of another epoch or
    # unit would put them seconds apart)
    assert after.min() >= -ALIGNMENT_US
    assert p.launches("decode_step") == matched.sum()
    assert p.launches("attend", within="decode_step") > 0
