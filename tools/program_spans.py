"""Device time, launches and idle of a traced slice by the port's spans.

The port opens a range ``repro_torch.<kind>`` around its prefill and
decode calls, each block's norms, rotary embedding and attention, and
the trainer's update (``repro_torch.core.obs.program_span``) while a
``torch.profiler`` records.  :class:`Program` reads those ranges from
the profiler's raw events beside each device operation's launch: the
first CUDA runtime or driver call (``cudaLaunchKernel``,
``cuLaunchKernelEx``, ``cudaMemcpyAsync``, ...) that carries the
operation's correlation id.  Those calls are told by name: a host
operation's own id is another count, which may meet a device
operation's, and a kernel library's launch, made outside any torch
operator, is linked to none.  An operation counts under every range open
at its launch, by time and on any host thread: the autograd engine
launches a backward's kernels, and opens the recomputed blocks' ranges,
from a thread of its own.  That compares host times alone.  Idle under a
range sets the device's gaps against the host's ranges, on the
profiler's alignment of the two clocks, which an H100 showed off by up
to a millisecond a session.

The script runs a cell of the on-card benchmark (``cardbench/``) as the
benchmark does up to its traced slice, traces that slice itself and
prints one JSON object: the readings of :data:`READINGS`, and device
seconds, launches and idle seconds by span kind.  From the repo root on
a card:

    PYTHONPATH=src python3 tools/program_spans.py \\
        --workload deepseek-llm-7b.decode_batch --seed 2147483001 \\
        [--out build/spans.json]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from cardbench import trace  # noqa: E402

#: the prefix of the program's own ranges (``obs.PROGRAM_PREFIX``)
PORT = "repro_torch."
#: ranges that hold the others, whose device time the report splits
OUTER = ("prefill", "decode_step")


class Program:
    """What the program's own ranges say of the slice ``cardbench.traced``
    in a profiler's raw events (``prof.profiler.kineto_results.events()``).

    ``ranges`` holds the program's ranges that overlap the slice, kind ->
    sorted (start, end) in us.  The slice's device operations are taken
    as :func:`cardbench.trace.summarize` takes them, in its order, less
    any mirror of the program's ranges that a torch version leaves
    unmarked as an annotation (torch 2.11 marks them):
    ``start`` as recorded, ``us`` within the slice, ``launch`` the start
    of the runtime call that launched each, NaN where the trace holds
    none.  ``gaps`` are the slice's idle intervals."""

    def __init__(self, events):
        from torch.autograd import DeviceType

        outer, ports, launched, ops = [], [], {}, []
        for e in events:
            name, s, t = e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3
            if e.device_type() == DeviceType.CPU:
                if name == trace.OUTER:
                    outer.append((s, t))
                elif name.startswith(PORT):
                    ports.append((name[len(PORT):], s, t))
                elif name.startswith("cu"):
                    c = e.correlation_id()
                    launched[c] = min(s, launched.get(c, s))
            elif not e.is_user_annotation() and \
                    not name.startswith((trace.PREFIX, PORT)):
                ops.append((s, t, e.correlation_id()))
        if len(outer) != 1:
            raise RuntimeError(f"the trace holds {len(outer)} "
                               f"{trace.OUTER} ranges")
        lo, hi = outer[0]
        ranges: dict = {}
        for kind, s, t in sorted(ports):
            if t > lo and s < hi:
                ranges.setdefault(kind, []).append((s, t))
        ops = [op for op in ops if op[1] > lo and op[0] < hi]
        self.ranges = ranges
        self.window_us = hi - lo
        self.start = np.asarray([s for s, _, _ in ops], dtype=float)
        self.us = np.asarray([min(t, hi) - max(s, lo) for s, t, _ in ops],
                             dtype=float)
        self.launch = np.asarray([launched.get(c, np.nan) for _, _, c in ops],
                                 dtype=float)
        busy = sorted((max(s, lo), min(t, hi)) for s, t, _ in ops)
        self.busy_us = trace.union_us(busy)
        gaps, at = [], lo
        for s, t in busy:
            if s > at:
                gaps.append((at, s))
            at = max(at, t)
        if at < hi:
            gaps.append((at, hi))
        self.gaps = gaps

    def count(self, kind: str) -> int:
        """How many ``kind`` ranges overlap the slice."""
        return len(self.ranges.get(kind, ()))

    def device_us(self, kinds, within=None) -> float:
        """Device us of the operations launched under a range of ``kinds``
        (a kind or several) and, where given, of ``within``."""
        return float(self.us[self._mask(kinds, within)].sum())

    def launches(self, kinds, within=None) -> int:
        """How many device operations :meth:`device_us` counts."""
        return int(self._mask(kinds, within).sum())

    def idle_us(self, kinds) -> float:
        """Idle us of the slice while a range of ``kinds`` is open on the
        host, at any depth."""
        return _overlap_us(self.gaps, self._union(kinds))

    def report(self) -> dict:
        """The slice by span kind, with each of :data:`READINGS`."""
        kinds = sorted(self.ranges)
        matched = self.launch == self.launch            # not NaN
        out = {"window_s": self.window_us / 1e6,
               "busy_s": self.busy_us / 1e6,
               "idle_s": (self.window_us - self.busy_us) / 1e6,
               "device_ops": len(self.launch),
               "matched": float(matched.mean()) if len(matched) else None,
               "readings": {name: read(self)
                            for name, read in READINGS.items()},
               "spans": {k: {"count": self.count(k),
                             "device_s": self.device_us(k) / 1e6,
                             "launches": self.launches(k),
                             "idle_s": self.idle_us(k) / 1e6}
                         for k in kinds}}
        for o in OUTER:
            if self.count(o):
                out["device_s_within_" + o] = {
                    k: self.device_us(k, within=o) / 1e6 for k in kinds}
        return out

    def _union(self, kinds) -> list:
        """The union of the ``kinds`` ranges, as sorted disjoint [start,
        end]."""
        kinds = (kinds,) if isinstance(kinds, str) else tuple(kinds)
        merged: list = []
        for s, t in sorted(r for k in kinds for r in self.ranges.get(k, ())):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        return merged

    def _under(self, kinds) -> np.ndarray:
        iv = self._union(kinds)
        if not iv:
            return np.zeros(len(self.launch), dtype=bool)
        starts = np.asarray([s for s, _ in iv])
        ends = np.asarray([t for _, t in iv])
        i = np.searchsorted(starts, self.launch, side="right") - 1
        # a NaN launch sorts last and is under nothing
        return (i >= 0) & (self.launch < ends[np.maximum(i, 0)])

    def _mask(self, kinds, within) -> np.ndarray:
        mask = self._under(kinds)
        return mask if within is None else mask & self._under(within)


def _overlap_us(a: list, b: list) -> float:
    """Length of the overlap of two sorted lists of disjoint (start,
    end) intervals."""
    total, j = 0.0, 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            total += max(0.0, min(e, b[k][1]) - max(s, b[k][0]))
            k += 1
    return total


def _per(p: Program, kind: str, us: float):
    """``us`` over the count of ``kind`` ranges, in ms; None where the
    slice holds no device operation or no such range."""
    n = p.count(kind)
    return us / n / 1e3 if n and len(p.launch) else None


def decode_attn_ms(p: Program):
    """Device ms a decode step launched under ``attend`` (decode
    attention over the cache, its casts included)."""
    return _per(p, "decode_step", p.device_us("attend", within="decode_step"))


def decode_launches(p: Program):
    """Device operations a decode step launched."""
    n = p.count("decode_step")
    return p.launches("decode_step") / n if n and len(p.launch) else None


def decode_loop_idle_ms(p: Program):
    """The device's idle ms a decode step while the step is open on the
    host: every gap between its kernels, whatever the device waited on
    (at 64 rows on an H100 the host runs a full command buffer ahead, and
    most of it is the microsecond between back-to-back kernels)."""
    return _per(p, "decode_step", p.idle_us("decode_step"))


def prefill_norm_rope_share(p: Program):
    """Device time launched under ``norm`` or ``rope`` inside ``prefill``,
    in percent of the slice's busy time."""
    if not p.count("prefill") or not p.busy_us:
        return None
    return 100.0 * p.device_us(("norm", "rope"), within="prefill") \
        / p.busy_us


def train_optimizer_ms(p: Program):
    """Device ms a train step's update (AdamW) launched."""
    return _per(p, "optimizer", p.device_us("optimizer"))


#: the readings :meth:`Program.report` gives, each None where the slice
#: holds none of what it reads
READINGS = {f.__name__: f for f in (
    decode_attn_ms, decode_launches, decode_loop_idle_ms,
    prefill_norm_rope_share, train_optimizer_ms)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 7)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(REPO),
                    help="the checkout whose benchmark files name the cell")
    ap.add_argument("--out", help="also write the report here")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from cardbench import harness

    t0 = time.perf_counter()
    spec = harness.load_spec(Path(args.root), args.workload)
    run = harness.Run(spec, args.seed, torch.device(args.device), t0)
    state = spec.driver.prepare(run)
    run.sync()
    activities = [ProfilerActivity.CPU]
    if run.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with trace.span("traced"):
            spec.driver.trace_slice(run, state)
            run.sync()
    report = {"workload": args.workload, "seed": args.seed,
              **Program(prof.profiler.kineto_results.events()).report()}
    text = json.dumps(report)
    print(text, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return report


if __name__ == "__main__":
    main()
