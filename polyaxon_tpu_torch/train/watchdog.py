"""Pod-local step-progress watchdog of the port — its own copy of
``polyaxon_tpu/train/watchdog.py`` (which imports no JAX, but the port
imports nothing of the JAX package).

A training step that wedges (a deadlocked collective, a data loader parked
on a dead mount) hangs the loop while the process stays alive.
``Trainer.fit`` beats this watchdog once per completed step, and the
watchdog compares the silence against the run's own step-time distribution
(``stall_factor`` x the meter's p95, floored at ``min_s``). On firing it
dumps every thread's stack, calls ``on_stall`` and hard-exits with
:data:`WATCHDOG_EXIT_CODE`, so the run fails visibly and its retry budget
restarts it. Before the first completed step only ``compile_grace_s``
applies (the first step builds the kernels and warms the allocator).
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from typing import Callable, Optional

#: distinctive exit status for a watchdog hard-exit — shows up in pod
#: epitaphs so "stalled and self-killed" reads differently from a crash
WATCHDOG_EXIT_CODE = 86


def dump_thread_stacks(log: Callable[[str], None]) -> None:
    """Write every live thread's current stack through ``log`` (one call
    per line)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    for ident, frame in sys._current_frames().items():
        log(f"--- thread {names.get(ident, '?')} ({ident}) ---")
        for entry in traceback.format_stack(frame):
            for line in entry.rstrip().splitlines():
                log(line)


class StepWatchdog(threading.Thread):
    """Daemon thread watching step progress reported via :meth:`beat`.

    ``p95_s`` is a callable returning the current p95 step time in
    seconds (0/None while the reservoir is empty); the stall deadline is
    ``max(min_s, stall_factor * p95)``. ``on_stall(step, waited, limit)``
    runs before the exit for span/status/log flushing; ``exit_fn`` is
    ``os._exit`` in production and injectable for tests — a sys.exit
    would be swallowed by the thread, and a raise can't unwedge a loop
    stuck in a collective, which is the whole point of hard-exiting.
    """

    def __init__(
        self,
        stall_factor: float = 10.0,
        min_s: float = 120.0,
        compile_grace_s: float = 1800.0,
        p95_s: Optional[Callable[[], float]] = None,
        on_stall: Optional[Callable[[int, float, float], None]] = None,
        log: Callable[[str], None] = print,
        exit_fn: Callable[[int], None] = os._exit,
        exit_code: int = WATCHDOG_EXIT_CODE,
    ):
        super().__init__(daemon=True, name="plx-step-watchdog")
        self.stall_factor = float(stall_factor)
        self.min_s = float(min_s)
        self.compile_grace_s = float(compile_grace_s)
        self._p95_s = p95_s
        self._on_stall = on_stall
        self._log = log
        self._exit_fn = exit_fn
        self._exit_code = exit_code
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._last_step: Optional[int] = None
        self._last_t = time.monotonic()
        self.fired = False  # observable by tests / the trainer

    # -- progress reporting (called from the training loop) ----------------

    def beat(self, step: int) -> None:
        """Record step completion (step number + monotonic timestamp)."""
        with self._lock:
            self._last_step = int(step)
            self._last_t = time.monotonic()

    def touch(self) -> None:
        """Refresh the silence clock WITHOUT closing the build window: a
        serving engine idle before its first request is neither building
        nor stalled, but that request still gets the full
        ``compile_grace_s``, which a ``beat`` here would forfeit."""
        with self._lock:
            self._last_t = time.monotonic()

    def stop(self) -> None:
        self._stop.set()

    # -- the watch loop ----------------------------------------------------

    def _limit(self) -> float:
        """Current stall deadline in seconds of step silence."""
        if self._last_step is None:
            # no step has completed: compilation window
            return max(self.min_s, self.compile_grace_s)
        p95 = 0.0
        if self._p95_s is not None:
            try:
                p95 = float(self._p95_s() or 0.0)
            except Exception:
                p95 = 0.0
        return max(self.min_s, self.stall_factor * p95)

    def run(self) -> None:
        while not self._stop.wait(min(1.0, max(self.min_s / 4.0, 0.02))):
            with self._lock:
                step, last_t = self._last_step, self._last_t
            waited = time.monotonic() - last_t
            limit = self._limit()
            if waited <= limit:
                continue
            self.fired = True
            self._fire(step if step is not None else -1, waited, limit)
            return

    def _fire(self, step: int, waited: float, limit: float) -> None:
        try:
            self._log(
                f"[watchdog] no step completed for {waited:.1f}s "
                f"(limit {limit:.1f}s, last step {step}); dumping stacks "
                f"and hard-exiting so the retry budget can restart us")
            dump_thread_stacks(self._log)
            if self._on_stall is not None:
                self._on_stall(step, waited, limit)
        except Exception:
            traceback.print_exc()
        finally:
            self._exit_fn(self._exit_code)
