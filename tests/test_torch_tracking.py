"""The port's copies of the control-plane bridge, held against the JAX
package on the CPU: event files read back as equal events both ways, each
package's outage spool replayed by the other's ``Run``, the four verbs'
request paths and JSON bodies against one stdlib stub, the chaos budgets,
``SeriesBuffer`` points, the serve reporter's drain markers and payloads,
and the resource sampler off the GPU."""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from polyaxon_tpu.client.client import RunClient as JaxRunClient
from polyaxon_tpu.obs.history import SeriesBuffer as JaxSeriesBuffer
from polyaxon_tpu.resilience.chaos import ServeChaos as JaxServeChaos
from polyaxon_tpu.resilience.chaos import TrainerChaos as JaxTrainerChaos
from polyaxon_tpu.resilience.retry import RetryPolicy as JaxRetryPolicy
from polyaxon_tpu.serve.runtime import ServeReporter as JaxServeReporter
from polyaxon_tpu.tracking import events as jev
from polyaxon_tpu.tracking.run import Run as JaxRun
from polyaxon_tpu.tracking.writer import EventFileWriter as JaxWriter
from polyaxon_tpu.tracking.writer import read_events as jax_read_events
from polyaxon_tpu_torch.obs.history import SeriesBuffer
from polyaxon_tpu_torch.resilience.chaos import ServeChaos, TrainerChaos
from polyaxon_tpu_torch.resilience.retry import RetryPolicy
from polyaxon_tpu_torch.serve.runtime import ServeReporter
from polyaxon_tpu_torch.tracking import events as tev
from polyaxon_tpu_torch.tracking.client import ApiError, RunClient
from polyaxon_tpu_torch.tracking.resources import ResourceLogger, sample_gpu
from polyaxon_tpu_torch.tracking.run import Run
from polyaxon_tpu_torch.tracking.writer import EventFileWriter, list_event_names, read_events

TS = "2026-01-02T03:04:05.000006+00:00"


def _events(mod):
    """One event of each kind the writers carry, built from ``mod``'s
    classes with the same values."""
    return {
        ("metric", "loss"): mod.V1Event(timestamp=TS, step=3, metric=2),
        ("span", "train"): mod.V1Event(timestamp=TS, span=mod.V1EventSpan(
            name="train", start=1.5, end=2, meta={"steps": 4, "trace_id": "t"})),
        ("histogram", "h"): mod.V1Event(timestamp=TS, step=1, histogram=mod.V1EventHistogram(
            values=[0.5, 1], counts=[3, 4])),
        ("artifact", "checkpoints"): mod.V1Event(timestamp=TS, artifact=mod.V1EventArtifact(
            kind="checkpoint", path="outputs/checkpoints")),
        ("curve", "roc"): mod.V1Event(timestamp=TS, curve=mod.V1EventCurve(
            x=[0, 0.5, 1], y=[0, 0.8, 1], annotation="auc=0.9")),
        ("confusion", "cm"): mod.V1Event(timestamp=TS, confusion=mod.V1EventConfusion(
            x=["a", "b"], y=["a", "b"], z=[[1, 0], [2, 3]])),
        ("text", "note"): mod.V1Event(timestamp=TS, step=0, text="hello"),
        ("image", "sample"): mod.V1Event(timestamp=TS, step=2, image=mod.V1EventImage(
            path="assets/images/val/sample_2.png", width=4, height=3)),
    }


KINDS = list(_events(tev))


def _write(writer_cls, run_dir, events):
    w = writer_cls(str(run_dir))
    for (kind, name), ev in events.items():
        w.add(kind, name, ev)
    w.close()


class TestEvents:
    @pytest.mark.parametrize("key", KINDS, ids=[k for k, _ in KINDS])
    def test_port_events_read_back_by_the_jax_reader(self, tmp_path, key):
        _write(EventFileWriter, tmp_path, {key: _events(tev)[key]})
        got = jax_read_events(str(tmp_path), *key)
        assert [e.to_dict() for e in got] == [_events(jev)[key].to_dict()]
        assert got[0].kind == key[0]

    @pytest.mark.parametrize("key", KINDS, ids=[k for k, _ in KINDS])
    def test_jax_events_read_back_by_the_port_reader(self, tmp_path, key):
        _write(JaxWriter, tmp_path, {key: _events(jev)[key]})
        got = read_events(str(tmp_path), *key)
        assert [e.to_dict() for e in got] == [_events(jev)[key].to_dict()]
        assert got == [_events(tev)[key]]
        assert list_event_names(str(tmp_path), key[0]) == [key[1]]

    def test_lineage_records_dump_alike(self):
        kw = dict(name="ck", kind="checkpoint", path="outputs/checkpoints",
                  is_input=False, summary={"a": 1})
        assert tev.V1RunArtifact(**kw).to_dict() == jev.V1RunArtifact(**kw).to_dict()
        assert tev.V1RunArtifact.from_dict(jev.V1RunArtifact(**kw).to_dict()) == \
            tev.V1RunArtifact(**kw)

    def test_unknown_fields_are_refused(self):
        with pytest.raises(ValueError, match="unknown field"):
            tev.V1Event.from_dict({"timestamp": TS, "metrc": 1.0})


# -- the spool ----------------------------------------------------------------


class _Client:
    """A run client stand-in: raises ConnectionError while down, records
    each call (verb and arguments) while up."""

    def __init__(self, up: bool):
        self.up = up
        self.calls = []

    def __getattr__(self, verb):
        def call(**kwargs):
            if not self.up:
                raise ConnectionError("control plane down")
            self.calls.append((verb, kwargs))
            return {}
        return call


def _writes(run):
    """The same API-bound writes, in order, through either package's Run."""
    run.log_status("running", reason="Started")
    run.heartbeat(step=3, anomalies={"loss": 1}, rollbacks=1)
    run.report_progress(4)
    run.log_outputs(mfu=0.25, tokens_per_sec_per_chip=1234.5)
    run.log_artifact("checkpoints", "outputs/checkpoints", kind="checkpoint")


def _comparable(calls):
    # the incarnation is one id per tracking process, by design
    return [(v, {k: x for k, x in kw.items() if k != "incarnation"}) for v, kw in calls]


class TestSpool:
    @pytest.mark.parametrize("writer,replayer", [(Run, JaxRun), (JaxRun, Run)],
                             ids=["port-spool-jax-replay", "jax-spool-port-replay"])
    def test_one_package_replays_the_others_spool(self, tmp_path, writer, replayer):
        down = _Client(up=False)
        run = writer(run_uuid="u1", project="p", artifacts_path=str(tmp_path / "run"),
                     client=down)
        _writes(run)
        assert run.spool_depth == 5
        up = _Client(up=True)
        replayer(run_uuid="u1", project="p", artifacts_path=str(tmp_path / "run"), client=up)
        oracle = _Client(up=True)
        _writes(JaxRun(run_uuid="u1", project="p", artifacts_path=str(tmp_path / "oracle"),
                       client=oracle))
        assert _comparable(up.calls) == _comparable(oracle.calls)
        assert not (tmp_path / "run" / ".spool" / "api.jsonl").exists()


# -- the client against one stub ----------------------------------------------


class _Recorder(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, fail_first=()):
        self.requests = []
        self.fail_first = list(fail_first)  # statuses answered before the 200s

        class Handler(BaseHTTPRequestHandler):
            def do_POST(h):  # noqa: N805
                n = int(h.headers.get("Content-Length") or 0)
                raw = h.rfile.read(n) if n else b""
                if self.fail_first:
                    status = self.fail_first.pop(0)
                    h.send_response(status)
                    h.send_header("Content-Length", "0")
                    h.end_headers()
                    return
                self.requests.append((h.path, json.loads(raw) if raw else None))
                body = b"{}"
                h.send_response(200)
                h.send_header("Content-Type", "application/json")
                h.send_header("Content-Length", str(len(body)))
                h.end_headers()
                h.wfile.write(body)

            def log_message(h, *args):  # noqa: N805
                pass

        super().__init__(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.serve_forever, daemon=True).start()

    @property
    def url(self):
        return f"http://127.0.0.1:{self.server_address[1]}"

    def close(self):
        self.shutdown()
        self.server_close()


def _verbs(client):
    client.log_status("running", reason="Serving", message="replica 0")
    client.heartbeat()
    client.heartbeat(step=7, anomalies={"loss": 2}, rollbacks=1, incarnation="abc",
                     serve={"running": 1, "replica": 0},
                     metrics={"series": [{"family": "f", "points": [[0.5, 1.0]]}]})
    client.log_outputs(mfu=0.5, serve_ttft_p50_ms=12.5, nested={"a": [1, 2]})
    client.log_artifact_lineage(jev.V1RunArtifact(name="profile", kind="profile",
                                                  path="outputs/profile"))
    client.log_artifact_lineage({"name": "ck", "kind": "checkpoint", "isInput": False})


class TestClient:
    def test_the_four_verbs_send_what_the_jax_client_sends(self):
        stub = _Recorder()
        try:
            _verbs(JaxRunClient(stub.url, project="p", run_uuid="u1"))
            jax_requests, stub.requests = stub.requests, []
            _verbs(RunClient(stub.url, project="p", run_uuid="u1"))
            assert stub.requests == jax_requests
            assert [p for p, _ in jax_requests][:2] == [
                "/api/v1/p/runs/u1/statuses", "/api/v1/p/runs/u1/heartbeat"]
        finally:
            stub.close()

    def test_transient_statuses_retry_and_verdicts_do_not(self):
        fast = RetryPolicy(max_attempts=3, base_delay=0.0, jitter=0.0)
        stub = _Recorder(fail_first=[503, 429])
        try:
            RunClient(stub.url, project="p", run_uuid="u1", retry=fast).log_outputs(a=1)
            assert stub.requests == [("/api/v1/p/runs/u1/outputs", {"a": 1})]
            stub.fail_first = [409]
            with pytest.raises(ApiError) as e:
                RunClient(stub.url, project="p", run_uuid="u1", retry=fast).log_outputs(a=2)
            assert e.value.status == 409 and len(stub.requests) == 1
        finally:
            stub.close()

    def test_a_dead_first_host_rotates_to_the_next(self):
        stub = _Recorder()
        try:
            client = RunClient(f"http://127.0.0.1:9,{stub.url}", project="p", run_uuid="u1",
                               retry=RetryPolicy(max_attempts=1))
            client.heartbeat(step=1)
            assert client.host == stub.url
            assert stub.requests == [("/api/v1/p/runs/u1/heartbeat", {"step": 1})]
        finally:
            stub.close()

    def test_the_retry_policy_is_the_jax_policy(self):
        import random

        for p, j in ((RetryPolicy(), JaxRetryPolicy()),
                     (RetryPolicy(max_attempts=2, base_delay=0.1, max_delay=0.5),
                      JaxRetryPolicy(max_attempts=2, base_delay=0.1, max_delay=0.5))):
            assert [p.delay(i, random.Random(3)) for i in range(6)] == \
                [j.delay(i, random.Random(3)) for i in range(6)]
            for status in (400, 409, 410, 429, 500, 503):
                assert p.is_retryable(ApiError(status, "")) == j.is_retryable(ApiError(status, ""))


# -- chaos budgets ------------------------------------------------------------


class TestChaos:
    SPECS = [None, {}, {"nan_at_step": 2, "nan_count": 2},
             {"hang_at_step": 5, "hang_sleep_s": 0.5},
             {"straggler_at_step": 1, "straggler_sleep_s": 0.01, "hang_after_requests": 3}]

    @pytest.mark.parametrize("spec", SPECS)
    def test_trainer_chaos_from_spec_and_budgets(self, tmp_path, spec):
        port = TrainerChaos.from_spec(spec, state_dir=str(tmp_path / "port"))
        ref = JaxTrainerChaos.from_spec(spec, state_dir=str(tmp_path / "jax"))
        assert (port is None) == (ref is None)
        if port is None:
            return
        keys = ("hang_at_step", "nan_at_step", "nan_count", "straggler_at_step",
                "straggler_sleep_s", "hang_sleep_s")
        assert {k: getattr(port, k) for k in keys} == {k: getattr(ref, k) for k in keys}
        for chaos in (port, ref):
            chaos.hang_sleep_s = 0.0
            for pos in range(6):
                chaos.pre_step(pos)
                chaos.nan_due(pos)
        assert port.injected == ref.injected
        assert json.loads((tmp_path / "port" / "chaos-train.json").read_text()) == \
            json.loads((tmp_path / "jax" / "chaos-train.json").read_text())
        # a restarted attempt of the other package finds the budget spent
        again = TrainerChaos(nan_at_step=spec.get("nan_at_step"),
                             nan_count=spec.get("nan_count", 1),
                             state_dir=str(tmp_path / "jax"))
        assert not any(again.nan_due(pos) for pos in range(6))

    @pytest.mark.parametrize("spec,replica", [
        (None, 0), ({"hang_after_requests": 2}, 0), ({"hang_after_requests": 2}, 1),
        ({"hang_after_requests": 1, "replica": 1, "hang_sleep_s": 0.0}, 1)])
    def test_serve_chaos_from_spec_and_budgets(self, tmp_path, spec, replica):
        port = ServeChaos.from_spec(spec, replica=replica, state_dir=str(tmp_path / "port"))
        ref = JaxServeChaos.from_spec(spec, replica=replica, state_dir=str(tmp_path / "jax"))
        assert (port is None) == (ref is None)
        if port is None:
            return
        for chaos in (port, ref):
            chaos.hang_sleep_s = 0.0
            for done in range(4):
                chaos.maybe_hang(done)
        assert port.injected == ref.injected
        name = f"chaos-serve.json-r{replica}"
        assert json.loads((tmp_path / "port" / name).read_text()) == \
            json.loads((tmp_path / "jax" / name).read_text())


# -- history points and the serve reporter --------------------------------------


def test_series_buffer_drains_equal_points():
    t = [100.0]
    port, ref = SeriesBuffer(clock=lambda: t[0]), JaxSeriesBuffer(clock=lambda: t[0])
    for buf in (port, ref):
        assert buf.drain() is None
    for i in range(300):
        t[0] += 0.25
        for buf in (port, ref):
            buf.add("polyaxon_serve_requests_total", i, {"replica": "0"}, kind="counter")
            buf.add("polyaxon_serve_running_requests", i % 3, {"replica": "0"})
    t[0] += 1.0
    assert port.drain() == ref.drain()


class _Engine:
    """The engine surface a reporter reads."""

    def __init__(self):
        self.draining = False
        self.ttft = [0.01, 0.02]

    def begin_drain(self):
        self.draining = True

    def end_drain(self):
        self.draining = False

    def snapshot(self):
        return {"running": 1, "waiting": 2, "kv_blocks_used": 3, "kv_blocks_total": 8,
                "requests_total": 5, "tokens_total": 40, "decode_steps": 9,
                "tokens_per_sec": 12.3456, "ttft_p50_ms": 10.0, "ttft_p95_ms": 20.0,
                "intertoken_p50_ms": 1.0, "intertoken_p95_ms": 2.0, "rejected_total": 0,
                "preemptions_total": 0, "prefix_cache_hits": 1, "prefix_cache_misses": 3,
                "shared_kv_blocks": 0, "cow_copies": 0, "spec_tokens_proposed": 0,
                "spec_tokens_accepted": 0, "kv_audit_violations": 0,
                "draining": self.draining, "drained": False, "ready": True}

    def drain_observations(self):
        out, self.ttft = {"ttft": self.ttft, "itl": [0.001]}, []
        return out


class _Run:
    def __init__(self, run_dir):
        self.run_dir = str(run_dir)
        self.beats, self.outputs = [], []

    def heartbeat(self, **kw):
        self.beats.append(kw)

    def log_outputs(self, **kw):
        self.outputs.append(kw)


class TestServeReporter:
    def test_drain_marker_closes_then_reopens_admission(self, tmp_path):
        engine, run = _Engine(), _Run(tmp_path)
        reporter = ServeReporter(run, engine, interval=60, replica=1, port=8000)
        marker = tmp_path / "serve-drain-1.json"
        reporter.report_once()
        assert not engine.draining
        marker.write_text(json.dumps({"replica": 1}))
        reporter.report_once()
        assert engine.draining and run.beats[-1]["serve"]["draining"]
        marker.unlink()
        reporter.report_once()
        assert not engine.draining
        # a drain the reporter did not start (SIGTERM) is never reopened
        engine.begin_drain()
        reporter.report_once()
        assert engine.draining
        # an expired marker does not drain
        engine.end_drain()
        marker.write_text(json.dumps({"expires_at": 1.0}))
        reporter.report_once()
        assert not engine.draining

    def test_beats_and_outputs_equal_the_jax_reporters(self, tmp_path):
        runs = []
        for cls in (ServeReporter, JaxServeReporter):
            run, engine = _Run(tmp_path), _Engine()
            reporter = cls(run, engine, interval=60, replica=0, port=8123)
            reporter.report_once()
            reporter.report_once()
            runs.append(run)
        port, ref = runs

        def strip(beat):  # history points carry ages measured on each clock
            out = dict(beat)
            out["metrics"] = [(s["family"], s["labels"], s["kind"], [v for _, v in s["points"]])
                              for s in out["metrics"]["series"]]
            return out

        assert [strip(b) for b in port.beats] == [strip(b) for b in ref.beats]
        assert port.outputs == ref.outputs
        assert port.outputs[0]["serve_tokens_per_sec"] == 12.346
        assert port.beats[0]["serve"]["ttft"] == [0.01, 0.02]


# -- resources ------------------------------------------------------------------


def test_resource_logger_samples_the_host_and_no_gpu_here(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    assert sample_gpu() == {}
    run = Run(run_uuid="r", artifacts_path=str(tmp_path))
    sampled = ResourceLogger(run, interval=0.02).sample()
    assert "host_mem_used_gib" in sampled
    assert not any(k.startswith("gpu") for k in sampled)
    logger = ResourceLogger(run, interval=0.02).start()
    try:
        deadline = time.monotonic() + 10
        while not (tmp_path / "events" / "metric" / "host_mem_used_gib.jsonl").exists():
            assert time.monotonic() < deadline
            time.sleep(0.02)
    finally:
        logger.stop()
        run.end()
