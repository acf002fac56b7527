"""The reduction of a traced slice to busy time, idle gaps and the
breakdown, on events made by hand in the profiler's raw form."""

from __future__ import annotations

import pytest
from torch.autograd import DeviceType

import cardbench_tiny  # noqa: F401  (puts the checkout on sys.path)
from cardbench import trace


class Event:
    def __init__(self, name, start_us, end_us, cpu=False, annotation=False):
        self._n, self._s, self._e = name, start_us, end_us
        self._cpu, self._a = cpu, annotation

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


def host(name, s, e):
    return Event(trace.PREFIX + name, s, e, cpu=True, annotation=True)


EVENTS = [
    host("traced", 100, 200),
    host("prefill", 100, 150), host("first_token", 150, 170),
    Event("gemm", 90, 120), Event("gemm", 125, 140), Event("flash", 130, 145),
    Event("copy", 180, 190), Event("late", 195, 260),
    Event("aten::mm", 100, 110, cpu=True),            # a host op: no device
    Event(trace.PREFIX + "prefill", 100, 150, annotation=True),  # mirrored
    Event("outside", 10, 20),
]


def test_union_counts_overlap_once():
    assert trace.union_us([(0, 10), (5, 15), (20, 30), (21, 22)]) == 25


def test_summary_of_a_slice():
    s = trace.summarize(EVENTS)
    assert s.window_us == 100
    # clipped to the slice: gemm 100-120, 125-140, flash 130-145, copy
    # 180-190, late 195-200
    assert s.busy_us == pytest.approx(20 + 20 + 10 + 5)
    assert s.by_name == {"gemm": 35, "flash": 15, "copy": 10, "late": 5}
    assert s.idle_percent() == pytest.approx(45.0)
    # gaps: 120-125 and 145-150 in prefill, 150-170 in first_token,
    # 170-180 and 190-195 in the slice alone
    assert s.gaps == {trace.PREFIX + "prefill": 10,
                      trace.PREFIX + "first_token": 20,
                      trace.OUTER: 15}
    b = s.breakdown(top=2)
    assert b["device_ops"] == [["gemm", 35e-6], ["flash", 15e-6]]
    assert b["idle_gaps"][0] == [trace.PREFIX + "first_token", 20e-6]
    assert s.device_us(("flash", "copy")) == 25


def test_a_trace_needs_one_slice():
    with pytest.raises(RuntimeError):
        trace.summarize([e for e in EVENTS if e.name() != trace.OUTER])


def test_no_device_operation_reads_nothing():
    s = trace.summarize([host("traced", 0, 10)])
    assert s.idle_percent() is None
    assert s.breakdown()["idle_gaps"] == [[trace.OUTER, 10e-6]]
