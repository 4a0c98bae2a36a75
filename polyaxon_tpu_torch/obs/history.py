"""Metrics history shipping of the port — its own copy of
``SeriesBuffer`` from ``polyaxon_tpu/obs/history.py``.

Reporters (serve replicas, training pods) append points between beats and
attach :meth:`SeriesBuffer.drain` to the next heartbeat's ``metrics``
field; the control plane's recorder ingests them into its fleet history.
The wire shape carries AGES, not timestamps — the server re-stamps on its
own clock, so a reporter's clock skew cannot bend fleet history.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

#: per-beat cap on shipped points per series (the server's ingest cap)
MAX_SHIP_POINTS = 256


def _labels_key(labels: Optional[dict]) -> tuple:
    return tuple(sorted((labels or {}).items()))


class SeriesBuffer:
    """Client-side shipping buffer for the heartbeat bridge."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._points: dict[tuple, list] = {}
        self._kinds: dict[tuple, str] = {}

    def add(self, family: str, value: float, labels=None,
            kind: str = "gauge") -> None:
        key = (family, _labels_key(labels))
        with self._lock:
            pts = self._points.setdefault(key, [])
            pts.append((self._clock(), float(value)))
            del pts[:-MAX_SHIP_POINTS]
            self._kinds[key] = kind

    def drain(self) -> Optional[dict]:
        """The accumulated buffer as the server's ``ingest`` payload (ages
        computed at drain time), clearing it. None when empty — callers
        skip the heartbeat field entirely instead of shipping ``[]``."""
        now = self._clock()
        with self._lock:
            if not self._points:
                return None
            series = []
            for (family, lkey), pts in self._points.items():
                series.append({
                    "family": family,
                    "labels": dict(lkey),
                    "kind": self._kinds.get((family, lkey), "gauge"),
                    "points": [[round(max(now - t, 0.0), 3), v]
                               for t, v in pts],
                })
            self._points.clear()
            self._kinds.clear()
        return {"series": series}
