"""Minimal Prometheus-style metrics — the port's own copy of the parts of
``polyaxon_tpu/obs/metrics.py`` that the serving engine's meters and the
``/metrics`` route use (the port imports nothing of the JAX package).

No prometheus_client dependency: the text exposition format
(https://prometheus.io/docs/instrumenting/exposition_formats/) is simple
enough to hand-roll. Three metric types:

- :class:`Counter` — monotonically increasing; supports a ``value_fn`` so
  an existing count can be exported without double bookkeeping.
- :class:`Gauge` — instantaneous value, callback-backed.
- :class:`Histogram` — cumulative buckets + ``_sum``/``_count``, plus a
  bounded reservoir of recent observations so ``/stats`` can report
  exact p50/p95 next to the bucketed exposition.

All get-or-create through a :class:`MetricsRegistry`. Thread-safe:
observation paths take one small lock per call.
"""

from __future__ import annotations

import bisect
import collections
import math
import threading
from typing import Callable, Optional

_INF = float("inf")


def latency_buckets(lo: float = 0.002, hi: float = 120.0,
                    factor: float = 1.2) -> list[float]:
    """Geometric latency bucket bounds. The default factor (1.2) keeps
    bucket-interpolated quantiles within ~±20% of the true value — the
    consistency bound the schedule-latency acceptance check uses."""
    out = [lo]
    while out[-1] * factor < hi:
        out.append(out[-1] * factor)
    out.append(hi)
    return out


def _fmt(v: float) -> str:
    # Prometheus capitalization for non-finite values — a NaN-returning
    # gauge callback must still render a line parse_prometheus (the
    # contracted validator) accepts
    if math.isnan(v):
        return "NaN"
    if v == _INF:
        return "+Inf"
    if v == -_INF:
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return f"{float(v):.6g}"


def _labels_str(labels: Optional[dict]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class Counter:
    def __init__(self, name: str, help: str = "",
                 labels: Optional[dict] = None,
                 value_fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._value = 0.0
        self._value_fn = value_fn
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        if self._value_fn is not None:
            try:
                return float(self._value_fn())
            except Exception:
                return 0.0
        return self._value

    def render(self) -> list[str]:
        return [f"{self.name}{_labels_str(self.labels)} {_fmt(self.value)}"]


class Gauge:
    def __init__(self, name: str, help: str = "",
                 labels: Optional[dict] = None,
                 value_fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._value = 0.0
        self._value_fn = value_fn

    def set_fn(self, fn: Callable[[], float]) -> None:
        """Replace the callback — a successor agent re-binding the gauge
        to ITS in-memory state (the old incarnation's closure is dead)."""
        self._value_fn = fn

    @property
    def value(self) -> float:
        if self._value_fn is not None:
            try:
                return float(self._value_fn())
            except Exception:
                return 0.0
        return self._value

    def render(self) -> list[str]:
        return [f"{self.name}{_labels_str(self.labels)} {_fmt(self.value)}"]


class Histogram:
    def __init__(self, name: str, help: str = "",
                 buckets: Optional[list[float]] = None,
                 labels: Optional[dict] = None,
                 reservoir: int = 1024):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.bounds = sorted(buckets if buckets is not None
                             else latency_buckets())
        self._counts = [0] * (len(self.bounds) + 1)  # last = +Inf overflow
        self._sum = 0.0
        self._count = 0
        # bounded sample of recent observations: exact quantiles for JSON
        # surfaces; the Prometheus text stays bucket-based
        self._recent: collections.deque = collections.deque(maxlen=reservoir)
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        if not (isinstance(v, (int, float)) and math.isfinite(v)):
            return
        idx = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[idx] += 1
            self._sum += v
            self._count += 1
            self._recent.append(v)

    def quantile(self, q: float) -> Optional[float]:
        """Exact quantile over the recent-observation reservoir (None when
        empty). JSON-surface companion to the bucketed exposition."""
        with self._lock:
            vs = sorted(self._recent)
        if not vs:
            return None
        idx = min(int(round(q * (len(vs) - 1))), len(vs) - 1)
        return vs[idx]

    def render(self) -> list[str]:
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        lines = []
        cum = 0
        base = dict(self.labels)
        for bound, c in zip(self.bounds, counts):
            cum += c
            lines.append(
                f"{self.name}_bucket"
                f"{_labels_str({**base, 'le': _fmt(bound)})} {cum}")
        lines.append(
            f"{self.name}_bucket{_labels_str({**base, 'le': '+Inf'})} {total}")
        lines.append(f"{self.name}_sum{_labels_str(base)} {repr(float(s))}")
        lines.append(f"{self.name}_count{_labels_str(base)} {total}")
        return lines


class MetricsRegistry:
    """Get-or-create registry of metric families, rendered as Prometheus
    text. Families are keyed by (name, frozen labels) — re-registering an
    existing series returns it, so components restarted in-process keep
    their series continuous."""

    _TYPES = {Counter: "counter", Gauge: "gauge", Histogram: "histogram"}

    def __init__(self):
        self._metrics: dict[tuple, object] = {}
        self._lock = threading.Lock()

    def _key(self, name: str, labels: Optional[dict]) -> tuple:
        return (name, tuple(sorted((labels or {}).items())))

    def _get_or_create(self, cls, name, help, labels, **kw):
        key = self._key(name, labels)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, help=help, labels=labels, **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str, help: str = "",
                labels: Optional[dict] = None,
                value_fn: Optional[Callable[[], float]] = None) -> Counter:
        c = self._get_or_create(Counter, name, help, labels)
        if value_fn is not None:
            c._value_fn = value_fn
        return c

    def gauge(self, name: str, help: str = "",
              labels: Optional[dict] = None,
              value_fn: Optional[Callable[[], float]] = None) -> Gauge:
        g = self._get_or_create(Gauge, name, help, labels)
        if value_fn is not None:
            g.set_fn(value_fn)
        return g

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[list[float]] = None,
                  labels: Optional[dict] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   buckets=buckets)

    def families(self) -> dict[str, list]:
        """{family name: [metric, ...]} grouped across label sets."""
        out: dict[str, list] = {}
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            out.setdefault(m.name, []).append(m)
        return out

    def render(self) -> str:
        """Prometheus text exposition of every registered family."""
        lines: list[str] = []
        for name, metrics in sorted(self.families().items()):
            first = metrics[0]
            if first.help:
                lines.append(f"# HELP {name} {first.help}")
            lines.append(f"# TYPE {name} {self._TYPES[type(first)]}")
            for m in metrics:
                lines.extend(m.render())
        return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> dict[str, dict[str, float]]:
    """Parse Prometheus text into {family: {sample-name+labels: value}}.
    Strict enough to serve as the test-side validity check: every
    non-comment line must be ``name[{labels}] value``."""
    import re

    line_re = re.compile(
        r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(-?(?:\d+\.?\d*(?:[eE][+-]?\d+)?|\+Inf|-Inf|NaN))$"
    )
    out: dict[str, dict[str, float]] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        m = line_re.match(line)
        if m is None:
            raise ValueError(f"invalid Prometheus sample line: {raw!r}")
        name, labels, value = m.group(1), m.group(2) or "", m.group(3)
        family = re.sub(r"_(bucket|sum|count)$", "", name)
        out.setdefault(family, {})[name + labels] = float(value)
    return out
