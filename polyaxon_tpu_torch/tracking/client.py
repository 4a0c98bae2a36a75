"""The API client of a port pod's tracked run — the part of
``polyaxon_tpu/client/client.py`` that :class:`~.run.Run` calls
(``log_status``, ``heartbeat``, ``log_outputs``, ``log_artifact_lineage``),
on the standard library's ``urllib.request``.

The URL paths and JSON bodies are the JAX client's, and so is the failure
contract: ``ApiError.status`` carries the HTTP status; ``host`` is one
endpoint or an ordered, comma-separated failover list that the client
rotates through on a host-level failure (connection refused, or a 503);
transient failures retry under a :class:`~..resilience.retry.RetryPolicy`;
a 409 or 410 is a verdict and never retried.
"""

from __future__ import annotations

import json
import os
import urllib.error
import urllib.request
from typing import Any, Optional

from ..resilience.retry import DEFAULT_HTTP_RETRY, RetryPolicy, parse_retry_after


class ApiError(RuntimeError):
    def __init__(self, status: int, message: str,
                 retry_after: Optional[float] = None):
        super().__init__(f"API error {status}: {message}")
        self.status = status
        self.retry_after = retry_after


class RunClient:
    """Writes to one run: ``/api/v1/{project}/runs/{run_uuid}/...``."""

    def __init__(self, host: str = "http://127.0.0.1:8000", project: str = "default",
                 run_uuid: Optional[str] = None, timeout: float = 30.0,
                 auth_token: Optional[str] = None,
                 retry: Optional[RetryPolicy] = None):
        hosts = ([h.strip() for h in host.split(",")] if isinstance(host, str)
                 else [str(h).strip() for h in host])
        self.hosts = [h.rstrip("/") for h in hosts if h]
        if not self.hosts:
            raise ValueError("client needs at least one API endpoint")
        self._host_idx = 0
        self.timeout = timeout
        self.retry = retry if retry is not None else DEFAULT_HTTP_RETRY
        self.project = project
        self.run_uuid = run_uuid
        token = auth_token if auth_token is not None else os.environ.get("PLX_AUTH_TOKEN")
        self._headers = {"Authorization": f"Bearer {token}"} if token else {}

    @property
    def host(self) -> str:
        """The endpoint currently in use."""
        return self.hosts[self._host_idx]

    def _rpath(self, suffix: str = "", uuid: Optional[str] = None) -> str:
        uuid = uuid or self.run_uuid
        if not uuid:
            raise ValueError("run_uuid not set")
        return f"/api/v1/{self.project}/runs/{uuid}{suffix}"

    # -- transport --------------------------------------------------------------

    @staticmethod
    def _pre_commit(exc: BaseException) -> bool:
        """A failure provably before the server saw the request: urllib
        raises ``URLError`` for what goes wrong while connecting and
        sending, and lets a failure while reading the answer through."""
        return isinstance(exc, urllib.error.URLError) and not isinstance(
            exc, urllib.error.HTTPError)

    def _mutation_retryable(self, exc: BaseException) -> bool:
        """A POST is retried only when it cannot have been committed: an
        HTTP error answer (the server's handlers fail before or with their
        write) or a failure before the request was sent."""
        if isinstance(exc, ApiError):
            return self.retry.is_retryable(exc)
        return self._pre_commit(exc)

    def _rotate_on(self, exc: BaseException) -> bool:
        """Try the next endpoint: only on a host-level failure — a 503, or
        a failure before the request reached the host."""
        status = getattr(exc, "status", None)
        if status is not None:
            return status == 503
        return self._pre_commit(exc) or isinstance(exc, ConnectionRefusedError)

    def _req_once(self, method: str, path: str, body: Any) -> Any:
        data = None if body is None else json.dumps(body).encode("utf-8")
        headers = dict(self._headers)
        if data is not None:
            headers["Content-Type"] = "application/json"
        req = urllib.request.Request(self.host + path, data=data, method=method,
                                     headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                raw = resp.read()
        except urllib.error.HTTPError as e:
            text = e.read()[:500].decode("utf-8", "replace")
            raise ApiError(e.code, text, retry_after=parse_retry_after(e.headers)) from None
        return json.loads(raw) if raw else None

    def _req_sweep(self, method: str, path: str, body: Any) -> Any:
        """One attempt: a sweep across the endpoints from the current one."""
        last: Optional[BaseException] = None
        for _ in range(len(self.hosts)):
            try:
                return self._req_once(method, path, body)
            except Exception as e:  # noqa: BLE001 — classified below
                last = e
                if len(self.hosts) > 1 and self._rotate_on(e):
                    self._host_idx = (self._host_idx + 1) % len(self.hosts)
                    continue
                raise
        raise last

    def _post(self, path: str, body: Any) -> Any:
        return self.retry.call(self._req_sweep, "POST", path, body,
                               classify=self._mutation_retryable)

    # -- the verbs a tracked run sends --------------------------------------------

    def log_status(self, status: str, reason: Optional[str] = None,
                   message: Optional[str] = None, force: bool = False) -> Any:
        return self._post(self._rpath("/statuses"), {
            "status": status, "reason": reason, "message": message, "force": force})

    def heartbeat(self, uuid: Optional[str] = None, step: Optional[int] = None,
                  anomalies: Optional[dict] = None, rollbacks: Optional[int] = None,
                  incarnation: Optional[str] = None, serve: Optional[dict] = None,
                  metrics: Optional[dict] = None) -> Any:
        """Renew the run's liveness lease; ``step`` is training progress,
        ``serve`` a serving replica's traffic snapshot, ``metrics`` a
        drained ``SeriesBuffer`` payload."""
        body: dict = {}
        if step is not None:
            body["step"] = int(step)
        if anomalies:
            body["anomalies"] = anomalies
        if rollbacks:
            body["rollbacks"] = int(rollbacks)
        if incarnation:
            body["incarnation"] = str(incarnation)
        if serve is not None:
            body["serve"] = serve
        if metrics is not None:
            body["metrics"] = metrics
        return self._post(self._rpath("/heartbeat", uuid=uuid), body or None)

    def log_outputs(self, uuid: Optional[str] = None, **outputs: Any) -> Any:
        return self._post(self._rpath("/outputs", uuid=uuid), outputs)

    def log_artifact_lineage(self, artifact: Any, uuid: Optional[str] = None) -> Any:
        body = artifact.to_dict() if hasattr(artifact, "to_dict") else dict(artifact)
        return self._post(self._rpath("/lineage", uuid=uuid), body)
