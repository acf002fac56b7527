"""The traced slice of a run: ``torch.profiler`` over a fixed amount of
the cell's work, reduced to what the per-layer metrics read.

The harness names its own host ranges ``cardbench.<what>``
(:func:`span`) around each call it makes into the program; the whole
slice is the range ``cardbench.traced``.  From the trace it keeps:

* every device operation (kernels, copies, memsets; not the ranges the
  profiler mirrors onto the device timeline) that overlaps the slice;
* ``busy_s``: the union of those operations' intervals within the slice,
  so that operations which overlap are counted once;
* the idle gaps between them, each part labelled by the innermost
  harness range open on the host over it.
"""

from __future__ import annotations

from typing import Callable

__all__ = ["PREFIX", "Summary", "span", "capture", "union_us", "summarize"]

PREFIX = "cardbench."
OUTER = PREFIX + "traced"


def span(what: str):
    """A harness range on the host (a profiler range while tracing)."""
    from torch.profiler import record_function

    return record_function(PREFIX + what)


class Summary:
    """What a traced slice left: ``window_us``, ``busy_us``, device
    operations ``ops`` as (name, start_us, end_us), ``by_name``
    (device us by operation name) and ``gaps`` (idle us by host
    range)."""

    def __init__(self, window_us: float, ops: list, host: list):
        self.window_us = window_us
        self.ops = ops
        self.busy_us = union_us([(s, e) for _, s, e in ops])
        self.by_name: dict = {}
        for name, s, e in ops:
            self.by_name[name] = self.by_name.get(name, 0.0) + (e - s)
        self.gaps = _gaps(ops, host)

    def device_us(self, names) -> float:
        """Device us of the operations whose name holds any of ``names``."""
        return sum(us for n, us in self.by_name.items()
                   if any(k in n for k in names))

    def idle_percent(self):
        """The slice's idle share in percent; None where the trace holds
        no device operation (a run on the CPU)."""
        if not self.ops:
            return None
        return 100.0 * (1.0 - self.busy_us / self.window_us)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, us / 1e6] for n, us in ops],
                "idle_gaps": [[n, us / 1e6] for n, us in gaps]}


def union_us(intervals: list) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _gaps(ops: list, host: list) -> dict:
    """Idle us of the window's device timeline, by the innermost host
    range open over each part of each gap (the latest to start, the
    first to end).  ``host`` holds the window's ranges as (name, start,
    end), the outer one first."""
    outer = host[0]
    busy = sorted((max(s, outer[1]), min(e, outer[2])) for _, s, e in ops)
    gaps, at = [], outer[1]
    for s, e in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if at < outer[2]:
        gaps.append((at, outer[2]))
    edges = sorted({t for _, s, e in host for t in (s, e)})
    out: dict = {}
    for s, e in gaps:
        cuts = [s] + [t for t in edges if s < t < e] + [e]
        for a, b in zip(cuts, cuts[1:]):
            open_ = [h for h in host if h[1] <= a < h[2]]
            name = max(open_, key=lambda h: (h[1], -h[2]))[0]
            out[name] = out.get(name, 0.0) + (b - a)
    return out


def summarize(events) -> Summary:
    """A :class:`Summary` of the profiler's raw events
    (``prof.profiler.kineto_results.events()``: read as they are, without
    the profiler's own tree of function events, which takes minutes for
    a decode batch's million events)."""
    from torch.autograd import DeviceType

    host, ops = [], []
    for e in events:
        name, start, end = e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3
        if e.device_type() == DeviceType.CPU:
            if name.startswith(PREFIX):
                host.append((name, start, end))
        elif not e.is_user_annotation() and not name.startswith(PREFIX):
            ops.append((name, start, end))
    outers = [h for h in host if h[0] == OUTER]
    if len(outers) != 1:
        raise RuntimeError(f"the trace holds {len(outers)} {OUTER} ranges")
    outer = outers[0]
    host = [outer] + [h for h in host if h is not outer
                      and h[2] > outer[1] and h[1] < outer[2]]
    ops = [(n, max(s, outer[1]), min(e, outer[2]))
           for n, s, e in ops if e > outer[1] and s < outer[2]]
    return Summary(outer[2] - outer[1], ops, host)


#: traces taken before giving up, where the profiler has dropped a whole
#: slice's device events (seen once on an H100 by the port's
#: ``chip_smoke.py``)
ATTEMPTS = 3


def capture(work: Callable[[], object], sync: Callable[[], None],
            cuda: bool = True) -> tuple:
    """Run ``work`` inside ``cardbench.traced`` under ``torch.profiler``;
    returns (its result, the :class:`Summary`).  On a card a trace with
    no device operation is taken again, up to :data:`ATTEMPTS` times; on
    the CPU (the tests) there is none to wait for."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    for _ in range(ATTEMPTS):
        sync()
        with profile(activities=activities) as prof:
            with span("traced"):
                result = work()
                sync()
        summary = summarize(prof.profiler.kineto_results.events())
        if summary.ops or not cuda:
            return result, summary
    raise RuntimeError(f"the profiler recorded no device operation in "
                       f"{ATTEMPTS} traces")
