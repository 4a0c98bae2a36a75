"""Buffered event writers of the port's tracking — its own copy of
``polyaxon_tpu/tracking/writer.py``: user code never blocks on IO.

Layout under a run's artifacts dir (the contract the sidecar + streams
service read):

    events/metric/<name>.jsonl      one V1Event per line
    events/<kind>/<name>.jsonl      other kinds
    logs/<name>.plx.log             timestamped log lines
    outputs/...                     user artifacts
"""

from __future__ import annotations

import datetime
import os
import queue
import threading
from typing import Optional

from .events import V1Event

_SENTINEL = object()


class EventFileWriter:
    """Append V1Events to per-(kind, name) jsonl files from a writer thread."""

    def __init__(self, run_dir: str, flush_secs: float = 2.0):
        self.events_dir = os.path.join(run_dir, "events")
        os.makedirs(self.events_dir, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue()
        self._files: dict[tuple[str, str], object] = {}
        self._flush_secs = flush_secs
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def add(self, kind: str, name: str, event: V1Event) -> None:
        if self._closed:
            raise RuntimeError("writer closed")
        self._q.put((kind, name, event))

    def _path(self, kind: str, name: str) -> str:
        d = os.path.join(self.events_dir, kind)
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, f"{name}.jsonl")

    def _loop(self) -> None:
        while True:
            try:
                item = self._q.get(timeout=self._flush_secs)
            except queue.Empty:
                self._flush()
                continue
            if item is _SENTINEL:
                break
            kind, name, event = item
            f = self._files.get((kind, name))
            if f is None:
                f = open(self._path(kind, name), "a", encoding="utf-8")
                self._files[(kind, name)] = f
            f.write(event.to_jsonl() + "\n")
        self._flush()

    def _flush(self) -> None:
        # snapshot: flush() runs on the CALLER's thread while _loop may be
        # opening a first-event file — iterating the live dict races
        # ("dictionary changed size during iteration")
        for f in list(self._files.values()):
            f.flush()

    def flush(self, timeout: float = 10.0) -> None:
        """Block until queued events are on disk."""
        deadline = datetime.datetime.now().timestamp() + timeout
        while not self._q.empty():
            if datetime.datetime.now().timestamp() > deadline:
                break
            threading.Event().wait(0.01)
        self._flush()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._q.put(_SENTINEL)
        self._thread.join(timeout=10)
        for f in list(self._files.values()):
            f.close()
        self._files.clear()


class LogWriter:
    """Timestamped line-oriented log capture to ``logs/``."""

    def __init__(self, run_dir: str, name: str = "run"):
        d = os.path.join(run_dir, "logs")
        os.makedirs(d, exist_ok=True)
        self._f = open(os.path.join(d, f"{name}.plx.log"), "a", encoding="utf-8")
        self._lock = threading.Lock()

    def write(self, line: str) -> None:
        ts = datetime.datetime.now(datetime.timezone.utc).isoformat()
        with self._lock:
            self._f.write(f"{ts} {line.rstrip()}\n")
            self._f.flush()

    def close(self) -> None:
        self._f.close()


def read_events(run_dir: str, kind: str, name: str) -> list[V1Event]:
    path = os.path.join(run_dir, "events", kind, f"{name}.jsonl")
    if not os.path.exists(path):
        return []
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(V1Event.from_jsonl(line))
    return out


def list_event_names(run_dir: str, kind: str) -> list[str]:
    d = os.path.join(run_dir, "events", kind)
    if not os.path.isdir(d):
        return []
    return sorted(os.path.splitext(f)[0] for f in os.listdir(d) if f.endswith(".jsonl"))
