"""Outage-proof pod-side API writes — the port's own copy of
``polyaxon_tpu/tracking/spool.py``, with the same file names and record
format, so either package replays the other's spool.

A training pod's API-bound writes — statuses, outputs, heartbeats,
lineage — must survive a control-plane outage without killing or
stalling the run. When the API is unreachable, :class:`EventSpool`
captures each write as one JSONL record (idempotency key + monotonic
spool seq) in an append-only file under the run's artifacts dir, fsynced
per record; on reconnect the records replay IN ORDER, each acked
durably only after the server accepted it, so a crash mid-replay resumes
exactly where it left off — no gaps, and no duplicates beyond the one
ambiguous record a crash-between-accept-and-ack can re-send (which the
server-side verbs absorb: transitions dedupe via the status machine,
outputs merge by key, heartbeats are idempotent by nature).

The spool is deliberately dumb storage: ordering and delivery policy
live in :meth:`replay`'s caller (``tracking.Run``), which also enforces
the queue discipline — once anything is spooled, every later write is
appended BEHIND it until a full flush succeeds, so the server always
observes the pod's writes in emission order.
"""

from __future__ import annotations

import json
import os
import threading
import uuid as uuid_mod
from datetime import datetime, timezone
from typing import Callable, Optional


class EventSpool:
    """Append-only JSONL spool with a durable ack cursor.

    Files under ``<run_dir>/.spool/``: ``<name>.jsonl`` (the records) and
    ``<name>.ack`` (how many leading records the server has accepted,
    written atomically tmp+rename). A truncated final line (crash mid-
    append) is treated as never-written: the record's caller saw the
    append fail or died with it — either way the write never happened
    from the server's point of view."""

    def __init__(self, run_dir: str, name: str = "api", metrics=None,
                 labels: Optional[dict] = None):
        self.dir = os.path.join(run_dir, ".spool")
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, f"{name}.jsonl")
        self._ack_path = os.path.join(self.dir, f"{name}.ack")
        self._lock = threading.RLock()
        self._heal_tail()
        self._acked = self._read_ack()
        self._count = len(self._read_records())
        if metrics is not None:
            metrics.gauge(
                "polyaxon_tracking_spool_depth",
                "API writes spooled locally, awaiting replay",
                labels=labels, value_fn=lambda: float(self.depth))

    def _heal_tail(self) -> None:
        """Truncate a torn final line (crash mid-append). Healing must
        happen BEFORE the first append of a restarted attempt: appending
        onto a newline-less fragment would weld the new record onto the
        torn one into a single unparseable line, making it — and every
        record behind it — permanently unreplayable."""
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return
        if size == 0:
            return
        with open(self.path, "rb+") as f:
            f.seek(-1, os.SEEK_END)
            if f.read(1) == b"\n":
                return
            f.seek(0)
            cut = f.read().rfind(b"\n") + 1
            f.truncate(cut)
            f.flush()
            os.fsync(f.fileno())

    def _read_ack(self) -> int:
        try:
            with open(self._ack_path, encoding="utf-8") as f:
                return int(f.read().strip() or 0)
        except (OSError, ValueError):
            return 0

    def _write_ack(self) -> None:
        tmp = self._ack_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(str(self._acked))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._ack_path)

    def _read_records(self) -> list[dict]:
        if not os.path.exists(self.path):
            return []
        out: list[dict] = []
        with open(self.path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    break  # torn tail: the append never completed
        return out

    @property
    def depth(self) -> int:
        """Records spooled and not yet acked."""
        with self._lock:
            return max(self._count - self._acked, 0)

    def append(self, verb: str, kwargs: dict) -> dict:
        """Durably spool one API write: ``verb`` is the client method to
        replay, ``kwargs`` its (JSON-serializable) arguments."""
        with self._lock:
            rec = {
                "key": uuid_mod.uuid4().hex,
                "seq": self._count + 1,
                "verb": verb,
                "kwargs": kwargs,
                "ts": datetime.now(timezone.utc).isoformat(),
            }
            with open(self.path, "a", encoding="utf-8") as f:
                f.write(json.dumps(rec) + "\n")
                f.flush()
                os.fsync(f.fileno())
            self._count += 1
            return rec

    def pending(self) -> list[dict]:
        with self._lock:
            return self._read_records()[self._acked:]

    def replay(self, send: Callable[[dict], None]) -> int:
        """Deliver pending records in order: ``send(rec)`` raising aborts
        the replay (the remainder stays spooled, order intact); each
        success acks durably before the next record goes out. When the
        spool fully drains, the files are compacted away. Returns the
        number of records delivered."""
        with self._lock:
            recs = self.pending()
            done = 0
            for rec in recs:
                send(rec)  # raises to abort — rec stays pending
                self._acked += 1
                self._write_ack()
                done += 1
            if done and self.depth == 0:
                # ack file FIRST: if only the records file were removed,
                # a restarted pod would read ack=N over 0 records and
                # silently swallow the next N spooled writes (a permanent
                # gap). Losing the ack first fails toward a duplicate
                # replay, which the idempotent server verbs absorb.
                try:
                    os.remove(self._ack_path)
                    os.remove(self.path)
                except OSError:
                    pass
                self._count = 0
                self._acked = 0
            return done


__all__ = ["EventSpool"]
