"""Retry policy of the port's HTTP edges — its own copy of
``polyaxon_tpu/resilience/retry.py`` (the port imports nothing of the JAX
package).

One classification + backoff contract (jittered exponential, deadline
budget): a transient 5xx/429/timeout is retried within a bounded budget
and surfaced when the budget is spent. Deterministic when given a seeded
``random.Random``.
"""

from __future__ import annotations

import random as _random
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Optional

# HTTP statuses that signal a transient server/congestion condition. 4xx
# other than 429 means the request itself is wrong — retrying can't help.
RETRYABLE_STATUSES = frozenset({429, 500, 502, 503, 504})

# Statuses that are TERMINAL VERDICTS about the writer/cursor, never
# weather: 409 = a fencing conflict (the writer's lease token is stale —
# it must demote, not re-send) and 410 = an epoch fence (the ``?since=``
# cursor died with a store failover — full resync, not a re-poll).
# Pinned here so even a custom ``retry_statuses`` set cannot re-admit
# them: burning retry budget on a verdict delays the demotion/resync the
# rejection exists to trigger.
NEVER_RETRY_STATUSES = frozenset({409, 410})


def _status_of(exc: BaseException) -> Optional[int]:
    """HTTP status carried by an exception, if any (``ApiError.status``,
    urllib's ``HTTPError.code``, a ``response.status_code``)."""
    for attr in ("status", "code"):
        v = getattr(exc, attr, None)
        if isinstance(v, int):
            return v
    resp = getattr(exc, "response", None)
    v = getattr(resp, "status_code", None)
    return v if isinstance(v, int) else None


def default_classify(exc: BaseException) -> bool:
    """True when ``exc`` looks transient: retryable HTTP status, timeout,
    or connection-level failure (DNS, refused, reset, broken pipe)."""
    status = _status_of(exc)
    if status is not None:
        return (status not in NEVER_RETRY_STATUSES
                and status in RETRYABLE_STATUSES)
    if isinstance(exc, (TimeoutError, ConnectionError)):
        return True
    # urllib wraps socket errors in URLError (reason carries the cause);
    # requests exceptions subclass IOError — classify by name to avoid a
    # hard import dependency here
    name = type(exc).__name__
    if name in ("URLError", "ConnectTimeout", "ReadTimeout", "Timeout",
                "ConnectionError", "ChunkedEncodingError", "ProtocolError"):
        return True
    if isinstance(exc, OSError) and not isinstance(exc, (FileNotFoundError,
                                                         PermissionError,
                                                         IsADirectoryError)):
        # socket-level OSErrors (ECONNRESET et al.) are transient; genuine
        # filesystem errors are not
        return True
    return False


@dataclass(frozen=True)
class RetryPolicy:
    """Jittered exponential backoff under a total deadline budget.

    ``delay(attempt)`` grows ``base_delay * multiplier**attempt`` capped at
    ``max_delay``, with ``jitter`` fraction of it randomized (full jitter on
    that slice). A 429/503 carrying ``retry_after`` (seconds) on the
    exception overrides the computed delay, still capped at ``max_delay``.
    The policy object is immutable and safely shared across threads.
    """

    max_attempts: int = 5
    base_delay: float = 0.1
    max_delay: float = 5.0
    multiplier: float = 2.0
    jitter: float = 0.5          # fraction of the delay that is randomized
    deadline: float = 30.0       # total budget in seconds; <= 0 disables
    retry_statuses: frozenset = field(default_factory=lambda: RETRYABLE_STATUSES)

    def is_retryable(self, exc: BaseException) -> bool:
        status = _status_of(exc)
        if status is not None:
            # 409/410 are terminal even under a custom retry_statuses set
            return (status not in NEVER_RETRY_STATUSES
                    and status in self.retry_statuses)
        return default_classify(exc)

    def delay(self, attempt: int, rng: Optional[_random.Random] = None,
              exc: Optional[BaseException] = None) -> float:
        retry_after = getattr(exc, "retry_after", None) if exc else None
        if retry_after is not None:
            try:
                return min(float(retry_after), self.max_delay)
            except (TypeError, ValueError):
                pass
        d = min(self.base_delay * (self.multiplier ** attempt), self.max_delay)
        if self.jitter > 0:
            r = (rng or _random).random()
            d = d * (1.0 - self.jitter) + d * self.jitter * r
        return d

    def call(
        self,
        fn: Callable[..., Any],
        *args: Any,
        classify: Optional[Callable[[BaseException], bool]] = None,
        rng: Optional[_random.Random] = None,
        sleep: Callable[[float], None] = time.sleep,
        **kwargs: Any,
    ) -> Any:
        """Invoke ``fn(*args, **kwargs)``, retrying transient failures.

        Non-retryable exceptions propagate unchanged on the spot. When the
        attempt/deadline budget runs out, the LAST underlying exception
        propagates (not a wrapper) so callers' except clauses keep working.
        """
        classify = classify or self.is_retryable
        start = time.monotonic()
        attempt = 0
        while True:
            try:
                return fn(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 — classified below
                if not classify(e):
                    raise
                attempt += 1
                if attempt >= self.max_attempts:
                    raise
                # draw the next delay ONCE and test that same value against
                # the budget — a separate draw for the check would disagree
                # with the sleep under jitter
                d = self.delay(attempt - 1, rng, e)
                if self.deadline > 0 and (
                        time.monotonic() - start) + d > self.deadline:
                    raise
                sleep(d)

    def wrap(self, fn: Callable[..., Any], **call_kw: Any) -> Callable[..., Any]:
        def _wrapped(*args: Any, **kwargs: Any) -> Any:
            return self.call(fn, *args, **call_kw, **kwargs)

        _wrapped.__name__ = getattr(fn, "__name__", "wrapped")
        return _wrapped


def parse_retry_after(headers: Any) -> Optional[float]:
    """Seconds from a Retry-After header mapping, or None (absent or the
    HTTP-date form, which we don't parse). One shared implementation for
    every HTTP edge that stamps ``exc.retry_after``."""
    if headers is None:
        return None
    try:
        ra = headers.get("Retry-After")
        return float(ra) if ra is not None else None
    except (TypeError, ValueError, AttributeError):
        return None


# The default for API HTTP verbs: ~4 tries over a few seconds — long
# enough to ride out an API hiccup or a 429 burst, short enough that the
# callers' loops keep their cadence.
DEFAULT_HTTP_RETRY = RetryPolicy(max_attempts=4, base_delay=0.2,
                                 max_delay=3.0, deadline=15.0)


def iter_delays(policy: RetryPolicy, n: int,
                rng: Optional[_random.Random] = None) -> Iterable[float]:
    """The first ``n`` backoff delays (introspection/tests)."""
    return [policy.delay(i, rng) for i in range(n)]
