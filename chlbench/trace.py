"""Host spans of the harness's own calls, and the device trace of the
measured window.

`Spans` records a span (name, host start, host end, in
``time.perf_counter_ns``) around each call the harness makes into the
program, inside a ``torch.profiler.record_function`` of the same name.
`DeviceTrace` holds a ``torch.profiler`` window (CUDA activity only)
over the measured window and reads its device events straight from the
kineto results. A marker kernel launched right after a synchronise ties
the device clock to the host's, so an idle gap on the device can be put
down to the span the host was in.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import List, Optional, Tuple

#: innermost-span search: spans looked at before a gap is put down to
#: the harness's own code between calls
_BACK = 8


class Spans:
    def __init__(self):
        self.items: List[Tuple[str, int, int]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        import torch
        t0 = time.perf_counter_ns()
        with torch.profiler.record_function(name):
            yield
        self.items.append((name, t0, time.perf_counter_ns()))


def short_name(name: str) -> str:
    """A kernel's name without its namespaces' noise, cut to 96
    characters (enough to keep the functor of an elementwise kernel)."""
    for noise in ("void ", "(anonymous namespace)::", "at::native::",
                  "at::cuda::", "c10::"):
        name = name.replace(noise, "")
    return name[:96]


def union(intervals) -> List[Tuple[int, int]]:
    """Sorted, merged ``(start, end)`` intervals."""
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class DeviceTrace:
    """A profiler window with the host-to-device clock offset."""

    def __init__(self):
        self.prof = None
        self.offset_ns: Optional[int] = None
        self.events: List[Tuple[str, int, int]] = []

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self._mark_host = time.perf_counter_ns()
        torch.cuda._sleep(1000)                 # the clock marker
        torch.cuda.synchronize()

    def stop(self) -> None:
        from torch.autograd import DeviceType
        self.prof.__exit__(None, None, None)
        evs = [(e.name(), e.start_ns(), e.end_ns())
               for e in self.prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
        marks = [s for name, s, _ in evs if "spin_kernel" in name]
        if marks:
            self.offset_ns = min(marks) - self._mark_host
        self.events = [ev for ev in evs if "spin_kernel" not in ev[0]]
        self.prof = None


def summarize(trace: DeviceTrace, spans: Spans, window: Tuple[int, int],
              top: int = 10) -> Optional[dict]:
    """Busy seconds of the device over the host window ``(start, end)``
    (ns), with the breakdown: device time by operation, and idle time by
    the innermost harness span the host was in when each gap began.
    None when the trace holds no device event, or its clock could not
    be tied to the host's."""
    if not trace.events or trace.offset_ns is None:
        return None
    span_names = {name for name, _, _ in spans.items}
    lo, hi = (t + trace.offset_ns for t in window)
    evs = [(name, max(s, lo), min(e, hi)) for name, s, e in trace.events
           if name not in span_names and e > lo and s < hi]
    if not evs:
        return None
    busy = union((s, e) for _, s, e in evs)
    busy_ns = sum(e - s for s, e in busy)

    by_op = defaultdict(int)
    for name, s, e in evs:
        by_op[short_name(name)] += e - s
    gaps = []
    reach = lo
    for s, e in busy:
        if s > reach:
            gaps.append((reach, s))
        reach = max(reach, e)
    if hi > reach:
        gaps.append((reach, hi))

    items = sorted(spans.items, key=lambda x: x[1])
    starts = [s for _, s, _ in items]
    by_span = defaultdict(int)
    for g0, g1 in gaps:
        t = g0 - trace.offset_ns
        i = bisect.bisect_right(starts, t) - 1
        name = "between_calls"
        for j in range(i, max(-1, i - _BACK), -1):
            if items[j][2] >= t:
                name = items[j][0]
                break
        by_span[name] += g1 - g0

    def listed(d):
        return [[k, v / 1e9] for k, v in
                sorted(d.items(), key=lambda x: -x[1])[:top]]

    return {"busy_s": busy_ns / 1e9, "window_s": (hi - lo) / 1e9,
            "breakdown": {"device_ops": listed(by_op),
                          "idle_gaps": listed(by_span)}}
