"""A ``torch.profiler`` trace of a few steady steps, reduced to what the
per-layer readers need: each device kernel (name, start, duration), the
device's busy time inside the traced window, the idle gaps by what the
host was doing, and the same activity and gaps by the program's ``train.*``
ranges (``spans.py``).

The trace is exported as Chrome JSON into the temporary directory
(``TMPDIR``), read back and deleted. It is taken after the timed window:
once the profiler has run, every later launch in the process pays CUPTI's
host cost.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable

from . import kernels

WINDOW = "port_bench.traced_steps"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")


@dataclass
class Trace:
    steps: int
    window_s: float                       # host clock over the traced steps
    kernels: list = field(default_factory=list)    # (name, start_us, dur_us)
    busy_s: float = 0.0
    idle_by_host: list = field(default_factory=list)   # [name, seconds], longest first
    # by the program's ranges (spans.Spans); set by reduce, absent from
    # reduce.plain's
    spans: object = field(init=False, repr=False, compare=False)

    def seconds_by(self, layer: str) -> float:
        return sum(d for n, _, d in self.kernels if kernels.classify(n) == layer) / 1e6

    def device_ops(self, top: int = 10) -> list:
        totals: dict = {}
        for name, _, dur in self.kernels:
            key = kernels.short(name)
            totals[key] = totals.get(key, 0.0) + dur / 1e6
        return sorted(([k, v] for k, v in totals.items()), key=lambda kv: -kv[1])[:top]


def profile_steps(run: Callable[[], int], sync: Callable[[], None]) -> Trace:
    """Trace ``run()``, which runs some steps and returns how many."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    sync()
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            t0 = time.perf_counter()
            steps = run()
            sync()
            window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json", prefix="port_bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    del prof
    return reduce(events, steps, window_s)


def window(evs: list) -> tuple:
    """[start, end) of the span named :data:`WINDOW` (microseconds; the
    whole line where there is none)."""
    span = [e for e in evs if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not span:
        return float("-inf"), float("inf")
    return float(span[0]["ts"]), float(span[0]["ts"]) + float(span[0]["dur"])


def _union(device, lo: float, hi: float) -> list:
    """The union of ``device``'s (start, end, ...) intervals inside [lo,
    hi), as sorted [start, end] pieces."""
    merged: list = []
    for s, t, *_ in sorted(device, key=lambda x: x[:2]):
        s, t = max(s, lo), min(t, hi)
        if t <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return merged


def _gaps(merged: list, lo: float, hi: float) -> list:
    if not merged:
        return []
    gaps = [(merged[0][0] if lo == float("-inf") else lo, merged[0][0])]
    gaps += [(a[1], b[0]) for a, b in zip(merged, merged[1:])]
    gaps.append((merged[-1][1], merged[-1][1] if hi == float("inf") else hi))
    return [g for g in gaps if g[1] > g[0]]


def idle_gaps(device, lo: float, hi: float) -> list:
    """The (start, end) gaps in the union of ``device``'s intervals inside
    [lo, hi), from the first activity where the window is open at its
    start, to the last where it is open at its end."""
    return _gaps(_union(device, lo, hi), lo, hi)


def _reduce(events, steps: int, window_s: float) -> tuple:
    evs = events["traceEvents"] if isinstance(events, dict) else events
    evs = [e for e in evs if e.get("ph") == "X" and "dur" in e]
    lo, hi = window(evs)
    device = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e)
                     for e in evs if e.get("cat") in _DEVICE_CATS), key=lambda x: x[:2])
    trace = Trace(steps=steps, window_s=window_s)
    trace.kernels = [(e["name"], s, t - s) for s, t, e in device
                     if e.get("cat") == "kernel" and lo <= s < hi]
    merged = _union(device, lo, hi)
    trace.busy_s = sum(t - s for s, t in merged) / 1e6
    gaps = _gaps(merged, lo, hi)
    if gaps:
        trace.idle_by_host = _by_host(gaps, evs)
    return trace, evs, gaps


def reduce(events, steps: int, window_s: float) -> Trace:
    """The trace's events (Chrome JSON, times in microseconds) as a
    :class:`Trace` of the span named :data:`WINDOW`, with its ``spans``:
    the same device activity and idle gaps by the program's ranges."""
    from . import spans

    trace, evs, gaps = _reduce(events, steps, window_s)
    trace.spans = spans.reduce(evs, steps, gaps=gaps)
    return trace


def _plain(events, steps: int, window_s: float) -> Trace:
    return _reduce(events, steps, window_s)[0]


#: the reduction without the program's ranges (no ``spans``)
reduce.plain = _plain


def _by_host(gaps: list, evs: list, top: int = 10, longest: int = 2000) -> list:
    """The ``longest`` gaps' seconds under the innermost host op at each
    one's middle (an ATen op first, else a CUDA runtime or driver call;
    none: Python between ops), summed by name."""
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:longest]
    found = {}
    for cats in (("cpu_op",), _HOST_CATS):
        ops = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                      for e in evs if e.get("cat") in cats), key=lambda x: x[:2])
        starts = [o[0] for o in ops]
        for i, (a, b) in enumerate(gaps):
            if i in found:
                continue
            mid = (a + b) / 2
            j = bisect.bisect_right(starts, mid) - 1
            # the latest-starting op that still covers the middle is the
            # innermost of the nest there
            for k in range(j, max(j - 512, -1), -1):
                if ops[k][1] >= mid:
                    found[i] = ops[k][2]
                    break
    totals: dict = {}
    for i, (a, b) in enumerate(gaps):
        name = found.get(i, "(python between ops)")
        totals[name] = totals.get(name, 0.0) + (b - a) / 1e6
    return sorted(([k, v] for k, v in totals.items()), key=lambda kv: -kv[1])[:top]
