"""The traced steps by the program's phases: the ``train.*`` ranges that
``polyaxon_tpu_torch/obs/spans.py`` opens while a profiler records, read
from the same Chrome events ``trace.py`` reduces.

- Each device activity (kernel, copy, fill) inside the window goes to the
  nest of ``train.*`` ranges covering the host time of the CUDA API call
  that launched it (matched by ``correlation``). Time, not the
  thread, decides: the backward's launches come from the autograd engine's
  thread while the main thread waits inside ``train.backward``.
- Each idle gap goes to the nest at its middle: the gaps are
  ``trace.reduce``'s own list, which it hands to :func:`reduce`.
- Each synchronising CUDA runtime call goes to the nest at its start.

A nest is the tuple of covering range names, outermost first; ``()`` is
time under no range. A phase is the innermost of :data:`PHASES` in a nest.

``trace.reduce`` fills its :class:`trace.Trace`'s ``spans`` from
:func:`reduce`; the harness prints :meth:`Spans.line` (device ms, idle ms
and sync calls a step under each innermost range) to standard error.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

from . import trace
from .trace import idle_gaps  # trace.reduce's gap rule, for a trace reduced here alone

PREFIX = "train."
PHASES = ("train.forward", "train.loss", "train.backward", "train.optimizer")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
# the CUDA API calls (runtime and lower) among the host events trace.py reads
_LAUNCH_CATS = tuple(c for c in trace._HOST_CATS if c.startswith("cuda_"))
UNLAUNCHED = ("(no launch found)",)


@dataclass
class Spans:
    steps: int
    ranges: int = 0                                # train.* ranges in the window
    device_us: dict = field(default_factory=dict)  # nest -> device time, us
    idle_us: dict = field(default_factory=dict)    # nest -> idle time, us
    syncs: dict = field(default_factory=dict)      # nest -> sync calls

    def phase_ms(self, phase) -> float:
        """Device ms a step whose phase is ``phase`` (None: no phase)."""
        return sum(us for nest, us in self.device_us.items()
                   if phase_of(nest) == phase) / 1e3 / self.steps

    def loop_idle_ms(self) -> float:
        return sum(us for nest, us in self.idle_us.items()
                   if phase_of(nest) is None) / 1e3 / self.steps

    def by_range(self) -> dict:
        """Innermost range (``-`` for none) -> [device ms, idle ms, sync
        calls], a step each."""
        out: dict = {}
        for col, (table, per) in enumerate(((self.device_us, 1e3), (self.idle_us, 1e3),
                                            (self.syncs, 1))):
            for nest, v in table.items():
                row = out.setdefault(nest[-1] if nest else "-", [0.0, 0.0, 0.0])
                row[col] += v / per / self.steps
        return out

    def line(self) -> str:
        rows = sorted(self.by_range().items(), key=lambda kv: -kv[1][0])
        return ("spans a step [device ms, idle ms, sync calls]: "
                + (", ".join(f"{name} [{d:.3f}, {i:.3f}, {s:g}]" for name, (d, i, s) in rows)
                   or "no device activity"))


def phase_of(nest: tuple):
    for name in reversed(nest):
        if name in PHASES:
            return name
    return None


class _Nests:
    """The nest of ``train.*`` ranges at any time: the ranges' ends cut
    time into pieces, each with one nest."""

    def __init__(self, ranges: list):
        self.cuts = sorted({t for s, e, _ in ranges for t in (s, e)})
        self.nests = []
        for a, b in zip(self.cuts, self.cuts[1:]):
            mid = (a + b) / 2
            cover = sorted((s, -e, n) for s, e, n in ranges if s <= mid < e)
            self.nests.append(tuple(n for _, _, n in cover))

    def at(self, t: float) -> tuple:
        j = bisect.bisect_right(self.cuts, t) - 1
        return self.nests[j] if 0 <= j < len(self.nests) else ()


def _add(table: dict, key: tuple, v: float) -> None:
    table[key] = table.get(key, 0.0) + v


def reduce(events, steps: int, gaps=None) -> Spans:
    """The trace's events (Chrome JSON, times in microseconds) inside the
    span named ``trace.WINDOW``, by ``train.*`` range; ``gaps``: the idle
    gaps as ``trace.reduce`` found them (None: found here by its rule,
    ``trace.idle_gaps``)."""
    evs = events["traceEvents"] if isinstance(events, dict) else events
    evs = [e for e in evs if e.get("ph") == "X" and "dur" in e]
    lo, hi = trace.window(evs)
    ranges = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in evs
              if e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith(PREFIX)
              and lo <= float(e["ts"]) < hi]
    nests = _Nests(ranges)
    out = Spans(steps=max(int(steps), 1), ranges=len(ranges))
    launched = {}
    for e in evs:
        if e.get("cat") in _LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launched[corr] = float(e["ts"])
            if e.get("cat") == "cuda_runtime" and e.get("name") in SYNCS \
                    and lo <= float(e["ts"]) < hi:
                _add(out.syncs, nests.at(float(e["ts"])), 1)
    device = []
    for e in evs:
        if e.get("cat") not in trace._DEVICE_CATS:
            continue
        s, t = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        device.append((s, t))
        if lo <= s < hi:
            host = launched.get((e.get("args") or {}).get("correlation"))
            _add(out.device_us, UNLAUNCHED if host is None else nests.at(host), t - s)
    for a, b in idle_gaps(device, lo, hi) if gaps is None else gaps:
        _add(out.idle_us, nests.at((a + b) / 2), b - a)
    return out


def of(tr):
    """The traced steps' :class:`Spans`, or None where the trace holds no
    device activity."""
    sp = getattr(tr, "spans", None) if tr is not None else None
    if sp is None or not (sp.device_us or sp.idle_us):
        return None
    return sp


def phases_of(tr):
    """As :func:`of`, and None where the program opened no ``train.*``
    range."""
    sp = of(tr)
    return sp if sp is not None and sp.ranges else None
