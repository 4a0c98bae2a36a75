"""User-facing tracking API of the port — its own copy of
``polyaxon_tpu/tracking/run.py``:

    from polyaxon_tpu_torch import tracking
    tracking.init()                       # attaches via PLX_* env in-cluster
    tracking.log_metrics(step=i, loss=0.3, mfu=0.46)
    tracking.log_artifact("model", path, kind="checkpoint")

Events land in the run's artifacts dir (writer.py layout); when an API host
is configured, statuses, outputs, heartbeats and lineage also post there
(through the outage spool). Works fully offline. The environment contract
is the JAX package's, so the control plane launches either package's pods
the same way."""

from __future__ import annotations

import os
import time
import traceback
import uuid as uuid_mod
from typing import Any, Optional

from .events import (
    V1Event,
    V1EventArtifact,
    V1EventConfusion,
    V1EventCurve,
    V1EventHistogram,
    V1EventImage,
    V1EventSpan,
    V1RunArtifact,
)
from .spool import EventSpool
from .writer import EventFileWriter, LogWriter

# Env contract injected by the control plane's compiler and operator.
ENV_RUN_UUID = "PLX_RUN_UUID"
ENV_PROJECT = "PLX_PROJECT"
ENV_ARTIFACTS_PATH = "PLX_ARTIFACTS_PATH"
ENV_API_HOST = "PLX_API_HOST"
# trace correlation: pod-side spans join the control plane's run timeline
# through this id (defaults to the run uuid when absent)
ENV_TRACE_ID = "POLYAXON_TRACE_ID"


def _pod_retry():
    """The pod-side client's retry: SHORT. A control-plane outage routes
    writes to the local spool — a long in-line retry would
    stall the training step loop for the whole backoff budget at every
    log call, which is exactly the 'outage stalls the run' failure the
    spool exists to prevent. One quick re-try rides out a blip; anything
    longer is the spool's job."""
    from ..resilience.retry import RetryPolicy

    return RetryPolicy(max_attempts=2, base_delay=0.1, max_delay=0.5,
                       deadline=3.0)


def _spoolable(exc: BaseException) -> bool:
    """Failures the spool absorbs: the API is unreachable or transiently
    failing (connection errors, timeouts, 5xx/429 after the short retry).
    Terminal verdicts — fencing 409s, epoch 410s, plain 4xx — are NOT
    spooled: replaying them later would get the same answer."""
    status = getattr(exc, "status", None)
    if status is not None:
        return status in (429, 500, 502, 503, 504)
    # urllib's URLError subclasses OSError; TimeoutError/ConnectionError
    # cover the in-proc and socket paths
    return isinstance(exc, (ConnectionError, TimeoutError, OSError))


class Run:
    """A tracked run: event/log writers + optional API client binding."""

    def __init__(
        self,
        run_uuid: Optional[str] = None,
        project: Optional[str] = None,
        artifacts_path: Optional[str] = None,
        api_host: Optional[str] = None,
        client: Any = None,
    ):
        self.run_uuid = run_uuid or os.environ.get(ENV_RUN_UUID) or uuid_mod.uuid4().hex
        self.project = project or os.environ.get(ENV_PROJECT, "default")
        base = artifacts_path or os.environ.get(ENV_ARTIFACTS_PATH)
        if base is None:
            base = os.path.join(os.getcwd(), ".plx", "runs", self.run_uuid)
        self.run_dir = base
        self.trace_id = os.environ.get(ENV_TRACE_ID) or self.run_uuid
        # one id per tracking PROCESS: progress reports carry it so the
        # store's train-counter delta accounting can tell "restarted
        # attempt, cumulatives reset" from "stale relay of an old value"
        self.incarnation = uuid_mod.uuid4().hex[:12]
        os.makedirs(self.run_dir, exist_ok=True)
        self._writer = EventFileWriter(self.run_dir)
        self._logger = LogWriter(self.run_dir)
        self._outputs: dict[str, Any] = {}
        self._lineage: list[V1RunArtifact] = []
        api_host = api_host or os.environ.get(ENV_API_HOST)
        if client is None and api_host:
            from .client import RunClient

            # api_host may be an ordered, comma-separated endpoint list
            # (primary + standbys): the client rotates through it
            client = RunClient(host=api_host, project=self.project,
                               run_uuid=self.run_uuid, retry=_pod_retry())
        self.client = client
        # outage-proof API writes: when the control plane is
        # unreachable, statuses/outputs/heartbeats/lineage spool to an
        # append-only local file and replay in order on reconnect. Only
        # API-bound runs carry a spool — a client-less (offline) run has
        # nothing to spool and must not litter its artifacts dir. A
        # leftover spool from a previous incarnation of this run (pod
        # crashed mid-outage) is picked up and drained here.
        self._spool = (EventSpool(self.run_dir)
                       if self.client is not None else None)
        self.spool_retry_interval = 5.0
        self._spool_probe_at = 0.0
        if self._spool is not None and self._spool.depth:
            try:
                self.flush_spool()
            except Exception:
                pass

    # -- API writes through the outage spool --------------------------------

    @property
    def spool_depth(self) -> int:
        """API writes waiting locally for the control plane to come back."""
        return self._spool.depth if self._spool is not None else 0

    def _api(self, verb: str, /, **kwargs: Any) -> Any:
        """One API-bound write. While the spool is non-empty every write
        is APPENDED behind it (emission order is part of the no-gaps
        contract), with a rate-limited reconnect probe; a fresh failure
        spools the write instead of raising into the training loop.
        ``verb`` is positional-only so a user OUTPUT named "verb"
        (``log_outputs(verb=...)``) cannot collide with it."""
        if self.client is None:
            return None
        if self._spool.depth:
            if time.monotonic() >= self._spool_probe_at:
                try:
                    self.flush_spool()
                except Exception:
                    pass
            if self._spool.depth:
                self._spool.append(verb, kwargs)
                return None
        try:
            return getattr(self.client, verb)(**kwargs)
        except Exception as e:
            if not _spoolable(e):
                raise
            self._spool.append(verb, kwargs)
            self._spool_probe_at = (time.monotonic()
                                    + self.spool_retry_interval)
            return None

    def flush_spool(self) -> int:
        """Replay spooled writes in order. Unreachable-API failures abort
        the replay (everything undelivered stays spooled, order intact)
        and re-arm the probe timer; terminal rejections (a late status on
        a stopped run, a 4xx) are logged and DROPPED — holding the queue
        hostage to one unreplayable record would gap everything behind
        it. Returns records delivered (dropped ones count: they are
        resolved)."""
        if self.client is None or self._spool is None:
            return 0

        def _send(rec: dict) -> None:
            try:
                getattr(self.client, rec["verb"])(**rec["kwargs"])
            except Exception as e:
                if _spoolable(e):
                    self._spool_probe_at = (time.monotonic()
                                            + self.spool_retry_interval)
                    raise
                traceback.print_exc()  # terminal: drop, keep draining

        return self._spool.replay(_send)

    def heartbeat(self, step: Optional[int] = None,
                  anomalies: Optional[dict] = None,
                  rollbacks: Optional[int] = None,
                  serve: Optional[dict] = None,
                  metrics: Optional[dict] = None) -> None:
        """Renew this run's liveness lease (spooled through an outage so
        the post-failover reaper sees the replayed beats, not a corpse).

        ``step`` is the training-progress field the stall-aware
        reaper watches: a pod whose heartbeats stay fresh while ``step``
        freezes is wedged, not healthy. ``anomalies``/``rollbacks`` are
        the pod's CUMULATIVE divergence-guard counters — the store turns
        them into the ``polyaxon_train_*`` metric families by delta.

        ``metrics`` is a drained
        :class:`~polyaxon_tpu_torch.obs.history.SeriesBuffer` payload: the
        pod's local history points, merged into the server recorder's
        fleet rollup. Points carry AGES, so spool replay after an outage
        lands them in the past where they belong (at drain-time
        accuracy), never stacked on \"now\"."""
        kw: dict[str, Any] = {}
        if step is not None:
            kw["step"] = int(step)
        if anomalies:
            kw["anomalies"] = {k: int(v) for k, v in anomalies.items()}
        if rollbacks:
            kw["rollbacks"] = int(rollbacks)
        if serve is not None:
            # serve traffic snapshot: cumulative counters +
            # instantaneous gauges + drained TTFT/inter-token samples; the
            # store deltas/aggregates per reporter incarnation
            kw["serve"] = dict(serve)
        if metrics is not None:
            kw["metrics"] = dict(metrics)
        if anomalies or rollbacks or serve is not None or metrics is not None:
            kw["incarnation"] = self.incarnation
        self._api("heartbeat", **kw)

    #: run-dir file the agent-side sidecar reads to bridge pod progress
    #: into store heartbeats for runs with no API client (offline pods)
    PROGRESS_FILE = "progress.json"

    def report_progress(self, step: int, anomalies: Optional[dict] = None,
                        rollbacks: Optional[int] = None) -> None:
        """Publish training progress: atomically write ``progress.json``
        into the run dir (tmp + rename — the sidecar never reads a torn
        file) AND renew the API heartbeat with the ``step`` field. The
        builtin runtime calls this rate-limited from the training loop."""
        import json

        payload: dict[str, Any] = {"step": int(step), "at": time.time(),
                                   "incarnation": self.incarnation}
        if anomalies:
            payload["anomalies"] = {k: int(v) for k, v in anomalies.items()}
        if rollbacks:
            payload["rollbacks"] = int(rollbacks)
        tmp = os.path.join(self.run_dir, "." + self.PROGRESS_FILE + ".tmp")
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(payload, f)
            os.replace(tmp, os.path.join(self.run_dir, self.PROGRESS_FILE))
        except OSError:
            pass  # progress publishing must never fail the training loop
        self.heartbeat(step=step, anomalies=payload.get("anomalies"),
                       rollbacks=payload.get("rollbacks"))

    def flush(self) -> None:
        """Flush buffered events/logs to disk NOW — the watchdog calls
        this right before a hard exit so the training_stalled span and
        the stack dump survive the process."""
        self._writer.flush()

    # -- logging -----------------------------------------------------------

    def log_metrics(self, step: Optional[int] = None, **metrics: float) -> None:
        for name, value in metrics.items():
            self._writer.add("metric", name, V1Event.make(step=step, metric=float(value)))

    def log_metric(self, name: str, value: float, step: Optional[int] = None) -> None:
        self.log_metrics(step=step, **{name: value})

    def log_text(self, name: str, text: str, step: Optional[int] = None) -> None:
        self._writer.add("text", name, V1Event.make(step=step, text=text))

    def log_histogram(
        self, name: str, values: list[float], counts: list[float], step: Optional[int] = None
    ) -> None:
        self._writer.add(
            "histogram", name,
            V1Event.make(step=step, histogram=V1EventHistogram(values=values, counts=counts)),
        )

    def log_image(self, name: str, image: Any, step: Optional[int] = None) -> None:
        """Log an image event: ``image`` is the path of an existing image
        file, copied into the run's assets. The event references the
        run-relative path. (The JAX package also takes an array and writes
        a PNG through PIL; the port takes files only.)"""
        import shutil

        if not isinstance(image, (str, os.PathLike)):
            raise TypeError("the port's log_image takes the path of an image file")
        # TensorBoard-style names ("val/sample") become subdirectories;
        # ".."/absolute components are rejected — an event name must never
        # write outside the run's assets dir
        parts = [p for p in str(name).replace("\\", "/").split("/") if p]
        if not parts or any(p == ".." for p in parts):
            raise ValueError(f"bad image name {name!r}")
        assets_rel = os.path.join("assets", "images", *parts[:-1])
        os.makedirs(os.path.join(self.run_dir, assets_rel), exist_ok=True)
        suffix = f"_{step}" if step is not None else ""
        src = str(image)
        ext = os.path.splitext(src)[1] or ".png"
        rel = os.path.join(assets_rel, f"{parts[-1]}{suffix}{ext}")
        shutil.copyfile(src, os.path.join(self.run_dir, rel))
        self._writer.add("image", name,
                         V1Event.make(step=step, image=V1EventImage(path=rel)))

    def log_span(self, name: str, start: float, end: float, **meta: Any) -> None:
        # every span carries the trace id so the timeline assembler can
        # join pod-side spans to the control-plane lifecycle (obs/trace.py)
        meta.setdefault("trace_id", self.trace_id)
        self._writer.add(
            "span", name,
            V1Event.make(span=V1EventSpan(name=name, start=start, end=end, meta=meta or None)),
        )

    def log_curve(self, name: str, x: list, y: list,
                  annotation: Optional[str] = None,
                  step: Optional[int] = None) -> None:
        """Log an x/y curve event (roc / pr / calibration).
        The Metrics tab charts the latest curve per name."""
        self._writer.add(
            "curve", name,
            V1Event.make(step=step, curve=V1EventCurve(
                x=[float(v) for v in x], y=[float(v) for v in y],
                annotation=annotation)),
        )

    def log_confusion(self, name: str, x: list, y: list,
                      z: list, step: Optional[int] = None) -> None:
        """Log a confusion-matrix event: ``x``/``y`` label axes and
        row-major counts ``z``. Rendered as a heat-shaded matrix."""
        self._writer.add(
            "confusion", name,
            V1Event.make(step=step, confusion=V1EventConfusion(
                x=list(x), y=list(y),
                z=[[float(v) for v in row] for row in z])),
        )

    def log_line(self, line: str) -> None:
        self._logger.write(line)

    # -- outputs / lineage -------------------------------------------------

    def log_outputs(self, **outputs: Any) -> None:
        self._outputs.update(outputs)
        self._api("log_outputs", **outputs)

    def log_artifact(
        self, name: str, path: str, kind: str = "file", is_input: bool = False,
        summary: Optional[dict] = None,
    ) -> None:
        art = V1RunArtifact(name=name, kind=kind, path=path, is_input=is_input, summary=summary)
        self._lineage.append(art)
        self._writer.add(
            "artifact", name,
            V1Event.make(artifact=V1EventArtifact(kind=kind, path=path)),
        )
        # spooled as the dict form (JSON round-trippable); the client
        # accepts both shapes
        self._api("log_artifact_lineage", artifact=art.to_dict())

    @property
    def outputs_dir(self) -> str:
        d = os.path.join(self.run_dir, "outputs")
        os.makedirs(d, exist_ok=True)
        return d

    # -- lifecycle ---------------------------------------------------------

    def log_status(self, status: str, reason: Optional[str] = None, message: Optional[str] = None) -> None:
        self._api("log_status", status=status, reason=reason, message=message)

    def end(self, status: Optional[str] = None) -> None:
        self._writer.flush()
        if self._outputs:
            # durable copy for the offline path: the agent merges this into
            # the store when the run finishes (scheduler/agent.py)
            import json

            with open(os.path.join(self.run_dir, "outputs.json"), "w", encoding="utf-8") as f:
                json.dump(self._outputs, f)
            self._api("log_outputs", **self._outputs)
        if status:
            self.log_status(status)
        if self._spool is not None and self._spool.depth:
            # last chance to drain before the process exits; whatever
            # stays is durable on disk — a restarted attempt (same run
            # dir) picks it up, and the agent's terminal outputs.json
            # merge covers the outputs either way
            try:
                self.flush_spool()
            except Exception:
                pass
        self._writer.close()
        self._logger.close()
        global _active
        if _active is self:
            # a later get_run() must mint a fresh Run, not hand back this
            # one with closed writers (matters for in-proc sequential runs)
            _active = None


# -- module-level convenience (`tracking.init()`) ---------------------------

_active: Optional[Run] = None


def init(**kwargs: Any) -> Run:
    global _active
    _active = Run(**kwargs)
    return _active


def get_run() -> Run:
    if _active is None:
        return init()
    return _active


def log_metrics(step: Optional[int] = None, **metrics: float) -> None:
    get_run().log_metrics(step=step, **metrics)


def log_outputs(**outputs: Any) -> None:
    get_run().log_outputs(**outputs)


def log_artifact(name: str, path: str, kind: str = "file", **kw: Any) -> None:
    get_run().log_artifact(name, path, kind=kind, **kw)


def end(status: Optional[str] = None) -> None:
    global _active
    if _active is not None:
        _active.end(status)
        _active = None
