"""``tools/program_spans.py``: the port's spans in a traced slice, read
beside each device operation's launch, on events made by hand in the
profiler's raw form with the correlation ids that tie a device operation
to the runtime call that launched it; and the script on a tiny cell of
the benchmark on the CPU."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from torch.autograd import DeviceType  # noqa: E402

from cardbench import trace  # noqa: E402
from repro_torch.core import obs  # noqa: E402
from tools import program_spans as ps  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


class Event:
    def __init__(self, name, start_us, end_us, cpu=False, annotation=False,
                 corr=0):
        self._n, self._s, self._e = name, start_us, end_us
        self._cpu, self._a = cpu, annotation
        self._c = corr

    def name(self):
        return self._n

    def start_ns(self):
        return self._s * 1000

    def end_ns(self):
        return self._e * 1000

    def device_type(self):
        return DeviceType.CPU if self._cpu else DeviceType.CUDA

    def is_user_annotation(self):
        return self._a

    def correlation_id(self):
        return self._c


def host(name, s, e):
    return Event(trace.PREFIX + name, s, e, cpu=True, annotation=True)


def port(kind, s, e):
    return Event(ps.PORT + kind, s, e, cpu=True, annotation=True)


def launch(corr, at, name="cudaLaunchKernel"):
    return Event(name, at, at + 2, cpu=True, corr=corr)


def kernel(name, corr, s, e):
    return Event(name, s, e, corr=corr)


HARNESS = [host("traced", 0, 1000), host("generate", 0, 900)]
#: a prefill and two decode steps, a sampling between them
SERVE_RANGES = [
    port("prefill", 10, 90), port("norm", 20, 30), port("rope", 40, 50),
    port("attend", 50, 60),
    port("decode_step", 100, 300), port("norm", 120, 130),
    port("rope", 145, 150), port("attend", 150, 200),
    port("decode_step", 400, 600), port("attend", 450, 500),
]
SERVE_OPS = [
    launch(1, 25), kernel("k_norm", 1, 30, 40),
    launch(2, 45), kernel("k_rope", 2, 60, 75),
    launch(3, 55), kernel("k_flash", 3, 80, 120),
    launch(4, 125), kernel("k_norm", 4, 130, 140),
    # launched inside attend, run after attend has closed on the host
    launch(5, 160), kernel("k_upcast", 5, 210, 280),
    launch(6, 210), kernel("k_gemm", 6, 280, 300),
    # the sampling, between the steps
    launch(7, 360, "cudaMemcpyAsync"), kernel("k_argmax", 7, 360, 370),
    launch(8, 455), kernel("k_upcast", 8, 470, 530),
    # a runtime call and the driver call inside it: the first counts
    launch(9, 550, "cudaLaunchKernelExC"),
    launch(9, 551, "cuLaunchKernelEx"), kernel("k_gemm", 9, 560, 580),
    # no runtime call carries its id; a host operation's id meets it
    kernel("k_lost", 10, 700, 710),
    Event("aten::mm", 450, 452, cpu=True, corr=10),
]
#: what the profiler mirrors onto the device's timeline (torch 2.11 marks
#: them as annotations)
MIRRORED = [Event(ps.PORT + "decode_step", 130, 300, annotation=True),
            Event(ps.PORT + "attend", 210, 280, annotation=True)]
SERVE = HARNESS + SERVE_RANGES + SERVE_OPS + MIRRORED

#: a training step: the forward's norm on the caller's thread, the
#: backward's kernels launched from the autograd engine's thread, which
#: opens the recomputed block's norm there, and the update
TRAIN = [
    host("traced", 0, 1000), host("train_step", 0, 950),
    port("norm", 40, 60), port("norm", 300, 320),
    port("optimizer", 700, 900),
    launch(1, 310), kernel("k_bwd_norm", 1, 320, 330),
    launch(2, 400), kernel("k_bwd_gemm", 2, 400, 500),
    launch(3, 50), kernel("k_fwd_norm", 3, 60, 100),
    launch(4, 710), kernel("k_adam", 4, 720, 800),
    launch(5, 750), kernel("k_adam", 5, 800, 850),
]


def test_the_prefix_is_the_programs():
    assert ps.PORT == obs.PROGRAM_PREFIX


def test_an_operation_counts_under_the_ranges_open_at_its_launch():
    p = ps.Program(SERVE)
    assert p.count("decode_step") == 2 and p.count("attend") == 3
    # k_upcast (5) by its launch at 160, though it starts once attend
    # has closed; k_upcast (8) in the second step
    assert p.launches("attend", within="decode_step") == 2
    assert p.device_us("attend", within="decode_step") == 70 + 60
    # k_gemm (6), launched at 210, under decode_step alone
    assert p.launches("decode_step") == 5
    assert p.device_us("decode_step") == 10 + 70 + 20 + 60 + 20
    assert p.device_us(("norm", "rope"), within="prefill") == 10 + 15
    # every operation but k_argmax, launched between the steps, and
    # k_lost: the host operation's id (at 450, in the second step's
    # attend) is no launch
    assert p.launches(("decode_step", "prefill")) == 8
    assert p.device_us("no_such_kind") == 0


def test_the_autograd_threads_launches_count_under_its_ranges():
    p = ps.Program(TRAIN)
    assert p.count("norm") == 2
    assert p.launches("norm") == 2
    assert p.device_us("norm") == 10 + 40
    assert p.device_us("optimizer") == 80 + 50
    # the backward's GEMM, launched under no range of the program
    assert p.launches(("norm", "optimizer")) == 4


@pytest.mark.parametrize("kinds,want", [
    # 80 us in the first step, 120 in the second
    ("decode_step", 200),
    # 10 in the prefill's, 50 in the first step's, 20 in the second's
    ("attend", 10 + 50 + 20),
    (("norm", "rope"), 10 + 10 + 10 + 5),
    ("prefill", 20 + 20 + 5),
    ("optimizer", 0),
])
def test_idle_counts_under_every_range_open_over_it(kinds, want):
    assert ps.Program(SERVE).idle_us(kinds) == pytest.approx(want)


def test_the_slice_is_the_summarys():
    p, s = ps.Program(SERVE), trace.summarize(SERVE)
    assert (p.window_us, p.busy_us) == (s.window_us, s.busy_us) == \
        (1000, 265)
    assert len(p.us) == len(s.ops) == 10
    assert list(p.us) == [e - b for _, b, e in s.ops]
    assert sum(t - s for s, t in p.gaps) == 1000 - 265
    # a mirror left unmarked is no device work of the view's
    unmarked = SERVE + [Event(ps.PORT + "attend", 210, 280)]
    assert len(ps.Program(unmarked).us) == 10


def test_the_programs_ranges_leave_the_summary_as_it_was():
    plain = [e for e in SERVE if not e.name().startswith(ps.PORT)]
    a, b = trace.summarize(SERVE), trace.summarize(plain)
    for field in ("window_us", "ops", "busy_us", "by_name", "gaps"):
        assert getattr(a, field) == getattr(b, field), field
    assert a.breakdown() == b.breakdown()
    assert ps.Program(plain).ranges == {}


def test_the_view_matches_launches_and_keeps_their_order():
    p = ps.Program(SERVE)
    matched = p.launch == p.launch          # not NaN
    assert matched.sum() == 9 and len(p.launch) == 10
    assert sorted(p.launch[matched]) == [25, 45, 55, 125, 160, 210, 360,
                                         455, 550]
    assert (p.start[matched] >= p.launch[matched]).all()


def test_the_slice_must_be_there_once():
    with pytest.raises(RuntimeError, match="0 cardbench.traced"):
        ps.Program(SERVE_RANGES + SERVE_OPS)


READINGS = {"decode_attn_ms": (SERVE, 130 / 2 / 1e3),
            "decode_launches": (SERVE, 5 / 2),
            "decode_loop_idle_ms": (SERVE, 200 / 2 / 1e3),
            "prefill_norm_rope_share": (SERVE, 100 * 25 / 265),
            "train_optimizer_ms": (TRAIN, 130 / 1e3)}


def test_every_reading_is_tested():
    assert sorted(READINGS) == sorted(ps.READINGS)


@pytest.mark.parametrize("name", sorted(READINGS))
def test_each_reading_reads_its_value_and_nothing_without_ranges(name):
    read = ps.READINGS[name]
    events, want = READINGS[name]
    assert read(ps.Program(events)) == pytest.approx(want)
    plain = [e for e in events if not e.name().startswith(ps.PORT)]
    assert read(ps.Program(plain)) is None
    # ranges and no device operation: a trace taken on the CPU
    cpu = [e for e in events if e.device_type() == DeviceType.CPU]
    assert read(ps.Program(cpu)) is None
    assert ps.Program(events).report()["readings"][name] == \
        pytest.approx(want)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    sys.path.insert(0, str(ROOT / "cardbench" / "tests"))
    import cardbench_tiny

    return cardbench_tiny.build(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell,kinds", [
    ("tiny.decode", ("prefill", "decode_step", "norm", "rope", "attend")),
    ("tiny.prefill", ("prefill", "norm", "rope", "attend")),
    ("tiny.train", ("norm", "rope", "attend", "optimizer")),
])
def test_the_script_reads_a_tiny_cells_spans_on_the_cpu(tiny, tmp_path,
                                                         cell, kinds):
    out = tmp_path / "spans.json"
    report = ps.main(["--root", str(tiny), "--workload", cell,
                      "--device", "cpu", "--seed", str(2 ** 31 + 5),
                      "--out", str(out)])
    assert sorted(report["spans"]) == sorted(kinds)
    spans = report["spans"]
    # two blocks, each with two norms, one rope and one attend a pass
    passes = spans["attend"]["count"] // 2
    assert passes >= 1 and spans["attend"]["count"] == 2 * passes
    assert spans["rope"]["count"] == 2 * passes
    # the CPU runs no device operation: nothing to read
    assert report["device_ops"] == 0 and report["matched"] is None
    assert set(report["readings"].values()) == {None}
    assert out.read_text().strip().startswith("{")
