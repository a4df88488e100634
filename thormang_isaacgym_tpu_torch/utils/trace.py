"""Spans inside the training iteration, on the profiler's clock.

``span(name)`` is a context manager around one phase, named
``<module>.<phase>``; the outermost ``learn.iteration`` (a learner's
``train_iteration``) opens and closes the record of one iteration. Each span
knows its name, its parent (the span open when it started), its start and
end and the iteration it belongs to. ``set_level`` picks what is kept:

- ``off``: nothing; ``span`` returns one shared no-op object.
- ``summary`` (the default): for each iteration, each span name's count,
  total and self time (the total less its children's), in a deque of the
  last ``KEEP`` iterations (``iterations()``), each with whether a profiler
  was running when it began. Two host-clock reads and a few dict updates a
  span, 1-2 us in CPython; a training iteration has 100-400 spans.
- ``annotate``: also opens a profiler range named after the span, so a
  running profiler puts each span on its timeline above the kernels it
  launched, and keeps each span's (name, parent, start, end) in its
  iteration's record. The range is a ``RecordFunction``, as
  ``torch.profiler.record_function`` opens, but entered from C++
  (``torch._C._profiler._RecordFunctionFast``) in about 1 us:
  ``record_function``'s Python entry takes 5-20 us, and hundreds on its
  first calls under a profiler, which parted its stamps from the span's
  by up to 0.3 ms. Only a profiled run that wants the phases (the CLI's
  ``profile_epoch``) sets this level, never a profiler merely running.

The stamps are ``time.time_ns()``: kineto's clock, taken just after the
range opens and closes, so a span's stamps and the profiler's range of it
agree to a few microseconds. No level synchronises with the device:
a span's time is the host's, launching the work inside it. The span counts
are the counters: ``fused.launch`` counts the physics kernel's launches.

Spans are opened by the one thread that drives training; the tracer is the
process's, as the profiler it feeds is.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import re
import time

import torch
from torch._C._profiler import _RecordFunctionFast

LEVELS = ("off", "summary", "annotate")
ROOT = "learn.iteration"
KEEP = 1024
OUTSIDE = "(outside)"   # profile_table's name for time and kernels outside every span
clock = time.time_ns
_RUNTIME = re.compile(r"cu(da)?[A-Z]")   # a CUDA API call: cudaLaunchKernel, cuLaunchKernel


@dataclasses.dataclass
class Record:
    """One iteration: ``spans`` {name: [count, total ns, self ns]};
    ``events`` (annotate only) each span's (name, parent, start, end)."""
    index: int
    profiled: bool
    start_ns: int
    end_ns: int = 0
    spans: dict = dataclasses.field(default_factory=dict)
    events: list | None = None

    def total_ms(self, name: str) -> float:
        return self.spans.get(name, (0, 0, 0))[1] * 1e-6

    def count(self, name: str) -> int:
        return self.spans.get(name, (0, 0, 0))[0]


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    __slots__ = ("tracer", "name", "parent", "start", "end", "child", "rf")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer, self.name, self.child, self.rf = tracer, name, 0, None

    def __enter__(self):
        tr = self.tracer
        stack = tr._stack
        self.parent = stack[-1] if stack else None
        stack.append(self)
        if tr.level == "annotate":
            self.rf = _RecordFunctionFast(self.name)
            self.rf.__enter__()
        self.start = clock()
        if self.parent is None and self.name == ROOT:
            tr._open(self.start)
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.end = end = clock()
        tr = self.tracer
        tr._stack.pop()
        total = end - self.start
        if self.parent is not None:
            self.parent.child += total
        rec = tr._rec
        if rec is not None:
            agg = rec.spans.get(self.name)
            if agg is None:
                rec.spans[self.name] = [1, total, total - self.child]
            else:
                agg[0] += 1
                agg[1] += total
                agg[2] += total - self.child
            if rec.events is not None:
                rec.events.append((self.name, self.parent.name if self.parent else None,
                                   self.start, end))
            if self.parent is None:
                rec.end_ns = end
                tr._rec = None
        return False


class Tracer:
    """The spans of one process (module functions below use ``TRACER``)."""

    def __init__(self, level: str = "summary"):
        self.level = "off"
        self.records = collections.deque(maxlen=KEEP)
        self.names = set()
        self._stack, self._rec, self._count = [], None, 0
        self.set_level(level)

    def set_level(self, level: str) -> str:
        """Set the level; returns the previous one."""
        if level not in LEVELS:
            raise ValueError(f"unknown trace level {level!r}; have {LEVELS}")
        prev, self.level = self.level, level
        return prev

    def span(self, name: str):
        if self.level == "off":
            return _NULL
        self.names.add(name)
        return _Span(self, name)

    def _open(self, start: int) -> None:
        self._rec = Record(index=self._count, profiled=torch._C._autograd._profiler_enabled(),
                           start_ns=start, events=[] if self.level == "annotate" else None)
        self._count += 1
        self.records.append(self._rec)

    def iterations(self) -> list:
        """The kept iteration records, oldest first."""
        return list(self.records)


TRACER = Tracer()
span = TRACER.span
set_level = TRACER.set_level
iterations = TRACER.iterations


# ---- the profile's table of spans (the CLI's profile/spans.json) ----

def profiler_events(prof) -> list:
    """(kind, name, start ns, end ns, correlation id) of a finished
    ``torch.profiler.profile``'s events: "span" (a host range of a span the
    tracer has opened), "launch" (a CUDA API call), "kernel",
    "device" (a copy or set). The spans' ranges put no copy on the device's
    timeline (``record_function``'s do)."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            kind = "device" if name.startswith(("Memcpy", "Memset")) else "kernel"
        elif name in TRACER.names:
            kind = "span"
        elif _RUNTIME.match(name):
            kind = "launch"
        else:
            continue
        out.append((kind, name, e.start_ns(), e.end_ns(), e.correlation_id()))
    return out


def profile_table(events) -> dict:
    """Each span name's host self ms, the kernels launched inside it (each
    kernel's launch found by its correlation id, charged to the innermost
    span open when the launch began), their device ms, and the device's
    idle ms (each gap between the busy intervals inside the spans' extent,
    charged to the innermost span open when it began); ``OUTSIDE`` takes
    what no span holds. Totals beside."""
    spans = sorted((s, -e, n) for k, n, s, e, _ in events if k == "span")
    table = collections.defaultdict(lambda: dict(host_self_ms=0.0, kernels=0, device_ms=0.0,
                                                 idle_ms=0.0))
    starts, labels, stack = [], [], []

    def mark(t, name):
        starts.append(t)
        labels.append(name)

    def close_until(t):
        while stack and stack[-1][1] <= t:
            s, e, name, child = stack.pop()
            table[name]["host_self_ms"] += (e - s - child) * 1e-6
            mark(e, stack[-1][2] if stack else OUTSIDE)

    for s, neg_e, name in spans:
        close_until(s)
        if stack:
            stack[-1][3] += -neg_e - s
        stack.append([s, -neg_e, name, 0])
        mark(s, name)
    close_until(float("inf"))

    def innermost(t):
        i = bisect.bisect_right(starts, t) - 1
        return labels[i] if i >= 0 else OUTSIDE

    launched = {c: s for k, _, s, _, c in events if k == "launch"}
    busy = []
    n_kernels = 0
    for k, _, s, e, c in events:
        if k in ("kernel", "device"):
            busy.append((s, e))
        if k == "kernel":
            n_kernels += 1
            row = table[innermost(launched[c]) if c in launched else OUTSIDE]
            row["kernels"] += 1
            row["device_ms"] += (e - s) * 1e-6
    idle = 0.0
    if spans:
        lo, hi = spans[0][0], max(-s[1] for s in spans)
        prev = lo
        for s, e in sorted(busy) + [(hi, hi)]:
            s = min(s, hi)
            if s > prev:
                table[innermost(prev)]["idle_ms"] += (s - prev) * 1e-6
                idle += (s - prev) * 1e-6
            prev = max(prev, min(e, hi))
    return dict(spans=dict(table), kernels=n_kernels, idle_ms=idle,
                window_ms=(hi - lo) * 1e-6 if spans else 0.0)
