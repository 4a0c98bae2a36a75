"""The port through the real product on the CPU: the JAX package's API
server and store, its agent on the cluster backend, and a pod whose
``container.command`` names the port's entry. The polyaxonfile's ``env``
caps each torch pod at two threads, so the pods share the test workers'
cores instead of asking for all of them.

(a) builtin: ``examples/llama1b_tpujob.yaml`` with ``bench.py
    --orchestrated``'s CPU overrides runs through
    ``polyaxon_tpu_torch.runtime.builtin``; the run succeeds, its outputs
    carry the meter's keys equal to the pod's ``{"final": ...}`` line, and
    the store's heartbeat step is the last step.
(b) service: a ``kind: service`` run served by
    ``polyaxon_tpu_torch.serve.runtime`` answers 2 concurrent /generate
    requests, and the run's outputs carry tokens/s and the TTFT
    percentiles (``tests/test_serve.py`` TestServeServiceE2E, in port
    form).
(c) distributed: ``examples/resnet50_ddp.yaml``'s ``pytorchjob`` on two
    pods trains as one gloo group from the converter's rendezvous env."""

from __future__ import annotations

import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest

from polyaxon_tpu.api.server import ApiServer
from polyaxon_tpu.client import RunClient
from polyaxon_tpu.polyaxonfile import check_polyaxonfile
from polyaxon_tpu.scheduler.agent import LocalAgent

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: bench.py --orchestrated's CPU overrides of the llama-1b recipe
BENCH_CPU = [
    "component.run.runtime.model=llama-tiny",
    "component.run.runtime.steps=3",
    "component.run.runtime.batch_size=8",
    "component.run.runtime.seq_len=64",
    "component.run.runtime.microbatches=1",
    "component.run.runtime.platform=cpu",
]
POD_ENV = [{"name": "OMP_NUM_THREADS", "value": "2"}]


@pytest.fixture
def stack(tmp_path):
    art = str(tmp_path / "artifacts")
    srv = ApiServer(db_path=":memory:", artifacts_root=art, port=0).start()
    agent = LocalAgent(srv.store, artifacts_root=art, api_host=srv.url,
                       backend="cluster", poll_interval=0.05)
    agent.start()
    try:
        yield srv, agent
    finally:
        agent.stop()
        srv.stop()


def _pod_logs(agent) -> str:
    return "\n".join(agent.cluster.pod_logs(n) for n in list(agent.cluster.pods))


def _wait_status(store, uuid, done, timeout):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        status = store.get_run(uuid)["status"]
        if status in done:
            return status
        time.sleep(0.2)
    return store.get_run(uuid)["status"]


def test_builtin_run_through_store_agent_and_pod(stack):
    srv, agent = stack
    spec = check_polyaxonfile(os.path.join(REPO, "examples", "llama1b_tpujob.yaml"),
                              set_overrides=BENCH_CPU).to_dict()
    spec["component"]["run"]["container"] = {
        "command": ["python", "-m", "polyaxon_tpu_torch.runtime.builtin"], "env": POD_ENV}
    uuid = srv.store.create_run(project="bench", name="llama1b-port", spec=spec)["uuid"]
    status = _wait_status(srv.store, uuid, ("succeeded", "failed", "stopped"), 300)
    logs = _pod_logs(agent)
    assert status == "succeeded", logs[-4000:]
    final = [json.loads(x)["final"] for x in logs.splitlines() if x.startswith('{"final"')]
    assert len(final) == 1
    final = final[0]
    run = srv.store.get_run(uuid)
    outputs = run["outputs"] or {}
    assert outputs["tokens_per_sec_per_chip"] == final["tokens_per_sec_per_chip"] > 0
    # the meter's MFU needs a card of its peak table: null on the CPU, in
    # the outputs as in the final line
    assert "mfu" in outputs and outputs["mfu"] == final["mfu"]
    for key in ("steps", "step_time_p50_ms", "tokens_per_sec", "resumed_from_step", "loss"):
        assert outputs[key] == final[key], key
    assert run["heartbeat_step"] == 3
    assert final["device"] == "cpu"


def test_pytorchjob_trains_its_pods_as_one_group(stack):
    """``examples/resnet50_ddp.yaml`` (a ``pytorchjob``) cut to resnet18-cifar
    on a master and one worker: each pod joins one gloo group from the
    rendezvous env the converter gives it, unchanged, and trains its half
    of the global batch; rank 0 alone prints the ``{"final"}`` line and
    reports the run."""
    srv, agent = stack
    spec = check_polyaxonfile(
        os.path.join(REPO, "examples", "resnet50_ddp.yaml"),
        set_overrides=["component.run.worker.replicas=1",
                       "component.run.runtime.model=resnet18-cifar",
                       "component.run.runtime.steps=3",
                       "component.run.runtime.batch_size=8",
                       "component.run.runtime.platform=cpu"]).to_dict()
    for role in ("master", "worker"):
        spec["component"]["run"][role]["container"] = {
            "command": ["python", "-m", "polyaxon_tpu_torch.runtime.builtin"],
            "env": POD_ENV}
    uuid = srv.store.create_run(project="bench", name="ddp-port", spec=spec)["uuid"]
    status = _wait_status(srv.store, uuid, ("succeeded", "failed", "stopped"), 300)
    logs = _pod_logs(agent)
    assert status == "succeeded", logs[-4000:]
    envs = [env for env in agent.cluster.launched_env.values()
            if env.get("PLX_NUM_PROCESSES")]
    assert sorted(env["PLX_PROCESS_ID"] for env in envs) == ["0", "1"]
    final = [json.loads(x)["final"] for x in logs.splitlines() if x.startswith('{"final"')]
    assert len(final) == 1 and final[0]["processes"] == 2
    outputs = srv.store.get_run(uuid)["outputs"] or {}
    assert outputs["loss"] == final[0]["loss"] and outputs["steps"] == final[0]["steps"]
    assert srv.store.get_run(uuid)["heartbeat_step"] == 3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get_ok(url) -> bool:
    try:
        with urllib.request.urlopen(url, timeout=1) as r:
            return r.status == 200
    except (urllib.error.URLError, OSError):
        return False


def _generate(url, prompt):
    req = urllib.request.Request(
        url + "/generate", data=json.dumps({"prompt": prompt, "max_new_tokens": 8}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_service_run_serves_concurrent_generates(stack):
    srv, agent = stack
    port = _free_port()
    op = check_polyaxonfile({
        "kind": "operation",
        "name": "tiny-serve-port",
        "component": {"kind": "component", "run": {
            "kind": "service",
            "ports": [port],
            "container": {"command": ["python", "-m", "polyaxon_tpu_torch.serve.runtime"],
                          "env": POD_ENV},
            "runtime": {
                "model": "llama-tiny", "platform": "cpu",
                "port": port, "max_slots": 4, "block_size": 8,
                "max_seq_len": 64, "prefill_chunk": 16,
                "report_interval": 0.5,
            }}},
    })
    uuid = srv.store.create_run(project="serve", name="tiny-serve-port",
                                spec=op.to_dict())["uuid"]
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 180
        while not _get_ok(url + "/healthz"):
            assert time.monotonic() < deadline, "serve pod never came up:\n" + _pod_logs(agent)
            time.sleep(0.3)
        assert (srv.store.get_run(uuid).get("meta") or {})["service"]["ports"] == [port]
        results = []
        threads = [threading.Thread(target=lambda p=p: results.append(_generate(url, p)))
                   for p in ("one concurrent", "two concurrent")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert len(results) == 2
        assert all(len(r["tokens"]) == 8 and r["ttft_ms"] is not None for r in results)
        # the traffic bridge: the reporter's beats land the outputs
        deadline = time.monotonic() + 60
        outputs = {}
        while time.monotonic() < deadline:
            outputs = srv.store.get_run(uuid).get("outputs") or {}
            if outputs.get("serve_requests_total", 0) >= 2 \
                    and outputs.get("serve_ttft_p50_ms") is not None:
                break
            time.sleep(0.3)
        assert outputs.get("serve_requests_total", 0) >= 2, outputs
        assert outputs.get("serve_tokens_total", 0) >= 16
        assert outputs["serve_tokens_per_sec"] > 0
        assert outputs["serve_ttft_p50_ms"] is not None
        assert outputs["serve_ttft_p95_ms"] is not None
        assert outputs["serve_port"] == port
        assert srv.store.get_run(uuid)["heartbeat_at"] is not None
        # the pod is the port's replica (its serving line names the device)
        serving = [json.loads(x)["serving"] for x in _pod_logs(agent).splitlines()
                   if x.startswith('{"serving"')]
        assert [s["device"] for s in serving] == ["cpu"]
    finally:
        RunClient(srv.url, project="serve").stop(uuid)
        _wait_status(srv.store, uuid, ("stopped", "failed"), 30)
