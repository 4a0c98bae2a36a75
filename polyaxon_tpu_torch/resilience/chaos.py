"""Fault injection inside the port's trainer and serving engine — its own
copy of ``TrainerChaos`` and ``ServeChaos`` from
``polyaxon_tpu/resilience/chaos.py``.

Budgets persist as JSON in the run's artifacts directory, in the same
files and keys as the JAX package's (``chaos-train.json``,
``chaos-serve.json-r<replica>``), so a restarted attempt of either
package runs clean once a fault was spent.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Optional


class TrainerChaos:
    """Trainer-level fault injection: the failure
    modes that happen INSIDE a training step rather than around the pod —
    a step that wedges in a collective (``hang_at_step``), a NaN/Inf
    burst poisoning the loss and gradients (``nan_at_step`` /
    ``nan_count``), and a straggler step that is merely slow
    (``straggler_at_step`` / ``straggler_sleep_s`` — must heal by
    *waiting*, never by reaping).

    Budgets persist in a marker file under ``state_dir`` (the run's
    artifacts dir, shared across attempts like the checkpoints): a
    RESTARTED attempt must not re-fire a spent fault, or the hang proof
    would hang every attempt until the retry budget burned out instead
    of proving watchdog -> retry -> resume. Same for the NaN window: the
    post-rollback replay of the poisoned steps runs clean, which is what
    lets the healed run converge to exact parity with the oracle.

    All step positions are DATA positions (batch indices), so injection
    keys on what was consumed, not on how many times the loop ran.
    """

    _STATE_FILE = "chaos-train.json"

    def __init__(self, hang_at_step: Optional[int] = None,
                 nan_at_step: Optional[int] = None, nan_count: int = 1,
                 straggler_at_step: Optional[int] = None,
                 straggler_sleep_s: float = 0.0,
                 state_dir: Optional[str] = None,
                 hang_sleep_s: float = 3600.0):
        self.hang_at_step = hang_at_step
        self.nan_at_step = nan_at_step
        self.nan_count = int(nan_count)
        self.straggler_at_step = straggler_at_step
        self.straggler_sleep_s = float(straggler_sleep_s)
        self.state_dir = state_dir
        self.hang_sleep_s = float(hang_sleep_s)
        self.injected: list[tuple[str, int]] = []  # (kind, step) audit
        self._state = self._load()

    @classmethod
    def from_spec(cls, spec: Any,
                  state_dir: Optional[str] = None) -> Optional["TrainerChaos"]:
        """Build from a builtin-runtime ``chaos:`` spec dict (None when the
        spec carries no trainer faults)."""
        if not isinstance(spec, dict):
            return None
        keys = ("hang_at_step", "nan_at_step", "nan_count",
                "straggler_at_step", "straggler_sleep_s", "hang_sleep_s")
        kw = {k: spec[k] for k in keys if spec.get(k) is not None}
        if not kw:
            return None
        return cls(state_dir=state_dir, **kw)

    # -- cross-attempt budget persistence ------------------------------------

    def _path(self) -> Optional[str]:
        if not self.state_dir:
            return None
        return os.path.join(self.state_dir, self._STATE_FILE)

    def _load(self) -> dict:
        path = self._path()
        if path:
            try:
                with open(path, encoding="utf-8") as f:
                    return json.load(f)
            except (OSError, ValueError):
                pass
        return {"hangs": 0, "nans": 0, "stragglers": 0}

    def _save(self) -> None:
        path = self._path()
        if not path:
            return
        os.makedirs(self.state_dir, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self._state, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)  # atomic: a kill mid-save never tears it

    # -- injection points (called by Trainer.fit) ----------------------------

    def pre_step(self, pos: int) -> None:
        """Host-side faults before the step at data position ``pos`` is
        dispatched: the one-shot hang (spends its budget BEFORE sleeping
        so the restarted attempt runs clean) and the straggler sleep."""
        if (self.straggler_at_step is not None
                and pos == self.straggler_at_step
                and self._state.get("stragglers", 0) < 1
                and self.straggler_sleep_s > 0):
            self._state["stragglers"] = 1
            self._save()
            self.injected.append(("straggler", pos))
            time.sleep(self.straggler_sleep_s)
        if (self.hang_at_step is not None and pos == self.hang_at_step
                and self._state.get("hangs", 0) < 1):
            self._state["hangs"] = 1
            self._save()
            self.injected.append(("hang", pos))
            time.sleep(self.hang_sleep_s)  # the watchdog ends this process

    def nan_due(self, pos: int) -> bool:
        """True when the step at data position ``pos`` should compute a
        non-finite loss/grad (budgeted to ``nan_count`` injections across
        every attempt and rollback replay)."""
        if self.nan_at_step is None:
            return False
        if not (self.nan_at_step <= pos < self.nan_at_step + self.nan_count):
            return False
        if self._state.get("nans", 0) >= self.nan_count:
            return False
        self._state["nans"] = self._state.get("nans", 0) + 1
        self._save()
        self.injected.append(("nan", pos))
        return True


class ServeChaos:
    """Serve-engine fault injection: wedge one replica's
    decode loop mid-traffic — ``hang_after_requests`` sleeps "forever"
    once the replica has COMPLETED that many requests, outside the
    scheduling lock so the replica keeps accepting (and shedding)
    requests exactly like a decode stuck inside a device call. The
    pod's watchdog must end the process; the budget marker persisted in
    ``state_dir`` (the run dir, shared across attempts) keeps the
    RESTARTED replica clean, so the soak proves watchdog -> retry ->
    fresh replica instead of hanging every attempt. ``replica`` scopes
    the fault to one replica index (every replica shares the spec)."""

    _STATE_FILE = "chaos-serve.json"

    def __init__(self, hang_after_requests: Optional[int] = None,
                 replica: int = 0, hang_sleep_s: float = 3600.0,
                 state_dir: Optional[str] = None):
        self.hang_after_requests = hang_after_requests
        self.replica = int(replica)
        self.hang_sleep_s = float(hang_sleep_s)
        self.state_dir = state_dir
        self.injected: list[tuple[str, int]] = []
        self._state = self._load()

    @classmethod
    def from_spec(cls, spec: Any, replica: int = 0,
                  state_dir: Optional[str] = None) -> Optional["ServeChaos"]:
        if not isinstance(spec, dict):
            return None
        if spec.get("hang_after_requests") is None:
            return None
        if int(spec.get("replica", 0)) != int(replica):
            return None
        return cls(hang_after_requests=int(spec["hang_after_requests"]),
                   replica=replica,
                   hang_sleep_s=float(spec.get("hang_sleep_s", 3600.0)),
                   state_dir=state_dir)

    def _path(self) -> Optional[str]:
        if not self.state_dir:
            return None
        return os.path.join(self.state_dir,
                            f"{self._STATE_FILE}-r{self.replica}")

    def _load(self) -> dict:
        path = self._path()
        if path:
            try:
                with open(path, encoding="utf-8") as f:
                    return json.load(f)
            except (OSError, ValueError):
                pass
        return {"hangs": 0}

    def _save(self) -> None:
        path = self._path()
        if not path:
            return
        os.makedirs(self.state_dir, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self._state, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def maybe_hang(self, requests_done: int) -> None:
        """Called by the engine loop between iterations."""
        if self.hang_after_requests is None:
            return
        if requests_done < self.hang_after_requests:
            return
        if self._state.get("hangs", 0) >= 1:
            return
        # spend the budget BEFORE sleeping: the watchdog hard-exits this
        # process, and the restarted attempt must run clean
        self._state["hangs"] = 1
        self._save()
        self.injected.append(("hang", requests_done))
        time.sleep(self.hang_sleep_s)


__all__ = ["ServeChaos", "TrainerChaos"]
