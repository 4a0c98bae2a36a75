"""The port's serving surface on the CPU: the stdlib HTTP routes
(/generate plain and streamed, /healthz, /stats, /metrics, /result/{id}),
``build_engine`` and its device rule, the command line, and a rehearsal of
``chip_smoke.py``'s main-path phases at llama-tiny size."""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from polyaxon_tpu_torch.__main__ import _parser, serve_spec
from polyaxon_tpu_torch.obs.metrics import parse_prometheus
from polyaxon_tpu_torch.serve import runtime
from polyaxon_tpu_torch.serve.server import build_server, decode_tokens, encode_prompt

ROOT = Path(__file__).resolve().parents[1]
TINY_SPEC = {"model": "llama-tiny", "platform": "cpu", "max_slots": 4,
             "block_size": 8, "max_seq_len": 64, "prefill_chunk": 16,
             "attn_impl": "flash"}


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


@pytest.fixture(scope="module")
def served():
    engine = runtime.build_engine(TINY_SPEC)
    engine.start()
    srv = build_server(engine, "127.0.0.1", 0, model_name="llama-tiny")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    yield engine, base
    srv.shutdown()
    srv.server_close()
    engine.stop()
    t.join(timeout=10)


class TestRoutes:
    def test_healthz_503_until_ready_then_200(self, served):
        engine, base = served
        if not engine.ready:
            status, body, _ = _get(base + "/healthz")
            assert status == 503 and json.loads(body)["ready"] is False
        runtime.warmup(engine)
        status, body, _ = _get(base + "/healthz")
        health = json.loads(body)
        assert status == 200 and health["ok"] and health["model"] == "llama-tiny"

    def test_generate_roundtrip(self, served):
        engine, base = served
        status, body, _ = _post(base + "/generate",
                                {"prompt": "hello", "max_new_tokens": 5})
        out = json.loads(body)
        assert status == 200 and len(out["tokens"]) == 5
        assert out["text"] == decode_tokens(out["tokens"], 256)
        assert out["num_tokens"] == 5 and out["ttft_ms"] > 0
        # the same request through the engine directly gives the same tokens
        ref = engine.generate(encode_prompt({"prompt": "hello"}, 256),
                              engine_sampling(5))
        assert ref.out_tokens == out["tokens"]

    def test_streaming_ndjson(self, served):
        _, base = served
        status, body, headers = _post(base + "/generate", {
            "tokens": [5, 6, 7, 8], "max_new_tokens": 4, "stream": True})
        lines = [json.loads(x) for x in body.decode().splitlines()]
        assert status == 200 and headers["Content-Type"] == "application/x-ndjson"
        toks = [m["token"] for m in lines[:-1]]
        assert len(toks) == 4 and lines[-1]["done"] and lines[-1]["tokens"] == toks

    def test_stats_metrics_and_result_by_id(self, served):
        # this test's own requests move the counter, whatever ran before it
        # on the shared server: two new ids, then one repeated (a cached
        # reply, which the counter does not count)
        _, base = served
        before = json.loads(_get(base + "/stats")[1])["requests_total"]
        status, body, _ = _post(base + "/generate", {
            "tokens": [9, 9, 9], "max_new_tokens": 3, "request_id": "abc"})
        assert status == 200
        first = json.loads(body)
        status, body, _ = _post(base + "/generate", {
            "tokens": [9, 8, 7], "max_new_tokens": 3, "request_id": "abd"})
        assert status == 200 and not json.loads(body).get("cached")
        status, body, _ = _post(base + "/generate", {
            "tokens": [9, 9, 9], "max_new_tokens": 3, "request_id": "abc"})
        again = json.loads(body)
        assert again["cached"] and again["tokens"] == first["tokens"]
        status, body, _ = _get(base + "/result/abc")
        assert status == 200 and json.loads(body)["tokens"] == first["tokens"]
        assert _get(base + "/result/nope")[0] == 404
        stats = json.loads(_get(base + "/stats")[1])
        assert stats["requests_total"] - before >= 2 and stats["kv_audit_violations"] == 0
        fams = parse_prometheus(_get(base + "/metrics")[1].decode())
        for fam in ("polyaxon_serve_requests_total",
                    "polyaxon_serve_ttft_seconds",
                    "polyaxon_serve_prefix_cache_hits_total"):
            assert fam in fams

    def test_bad_requests_are_4xx(self, served):
        _, base = served
        req = urllib.request.Request(base + "/generate", data=b"{not json",
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 400
        assert _post(base + "/generate", [1, 2])[0] == 400
        assert _post(base + "/generate", {"max_new_tokens": 2})[0] == 400
        assert _post(base + "/generate", {"tokens": list(range(60)),
                                          "max_new_tokens": 30})[0] == 400
        assert _get(base + "/nowhere")[0] == 404


def engine_sampling(n):
    from polyaxon_tpu_torch.serve.engine import SamplingParams

    return SamplingParams(max_new_tokens=n)


class TestOverloadAndDrainHTTP:
    def test_429_carries_retry_after_and_503_while_draining(self):
        engine = runtime.build_engine({**TINY_SPEC, "max_waiting": 0})
        srv = build_server(engine, "127.0.0.1", 0)
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            status, body, headers = _post(base + "/generate",
                                          {"tokens": [1], "max_new_tokens": 2})
            assert status == 429 and int(headers["Retry-After"]) >= 1
            assert json.loads(body)["retry_after_s"] >= 1.0
            engine.begin_drain()
            status, body, _ = _post(base + "/generate",
                                    {"tokens": [1], "max_new_tokens": 2})
            assert status == 503 and json.loads(body)["draining"]
            assert _get(base + "/healthz")[0] == 503
        finally:
            srv.shutdown()
            srv.server_close()


class TestBuildEngine:
    def test_cuda_is_the_default_and_raises_without_a_device(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        spec = {k: v for k, v in TINY_SPEC.items() if k != "platform"}
        with pytest.raises(RuntimeError, match="CUDA"):
            runtime.build_engine(spec)
        with pytest.raises(RuntimeError, match="CUDA"):
            runtime.build_engine({**spec, "platform": "cuda"})

    def test_explicit_cpu_builds_on_the_cpu(self):
        engine = runtime.build_engine(TINY_SPEC)
        assert engine.device.type == "cpu" and engine.attn_impl == "flash"
        assert engine.cache.k.device.type == "cpu"
        assert engine.provenance == {"restored_step": -1, "init_seed": 0}

    @pytest.mark.parametrize("key,value", [
        ("num_cpu_devices", 8),
    ])
    def test_unported_keys_are_refused(self, key, value):
        with pytest.raises(SystemExit, match=r"N-device mesh is N gloo ranks"):
            runtime.build_engine({**TINY_SPEC, key: value})

    @pytest.mark.parametrize("key,value", [
        ("report_interval", 0.1),
        ("watchdog", {"min_s": 5}),
        ("chaos", {"hang_after_requests": 3}),
    ])
    def test_bridge_keys_are_taken(self, key, value, tmp_path, monkeypatch):
        """A replica the control plane launched takes the bridge's keys: a
        reporter at the asked interval whose beats land the `serve_*`
        outputs, the decode watchdog on the engine, the chaos hook with its
        budget in the run directory."""
        monkeypatch.setenv("PLX_RUN_UUID", "bridge-keys")
        monkeypatch.setenv("PLX_ARTIFACTS_PATH", str(tmp_path))
        monkeypatch.delenv("PLX_API_HOST", raising=False)
        rep = runtime.start_replica({**TINY_SPEC, "port": 0, "warmup": False,
                                     key: value})
        try:
            if key == "report_interval":
                assert rep.reporter.interval == 0.1
                deadline = time.monotonic() + 30
                while "serve_requests_total" not in rep.run._outputs:
                    assert time.monotonic() < deadline, "no report"
                    time.sleep(0.05)
                assert rep.run._outputs["serve_port"] == rep.port
            elif key == "watchdog":
                assert rep.engine.watchdog is rep.watchdog and rep.watchdog.is_alive()
                assert rep.watchdog.min_s == 5
            else:
                assert rep.engine.chaos.hang_after_requests == 3
                assert rep.engine.chaos.state_dir == str(tmp_path)
        finally:
            rep.close()
            rep.run.end()

    def test_unknown_model_and_platform(self):
        with pytest.raises(SystemExit, match="Unknown model"):
            runtime.build_engine({**TINY_SPEC, "model": "gpt2-small"})
        with pytest.raises(ValueError, match="platform"):
            runtime.build_engine({**TINY_SPEC, "platform": "tpu"})

    def test_init_seed_selects_the_weights(self):
        a = runtime.build_engine({**TINY_SPEC, "init_seed": 1})
        b = runtime.build_engine({**TINY_SPEC, "init_seed": 1})
        c = runtime.build_engine({**TINY_SPEC, "init_seed": 2})
        w = lambda e: e.params["lm_head"]["w"]  # noqa: E731
        assert torch.equal(w(a), w(b)) and not torch.equal(w(a), w(c))


class TestCommandLine:
    def test_serve_options_map_to_the_spec(self):
        args = _parser().parse_args([
            "serve", "-m", "llama-1b", "--port", "9001", "--max-slots", "8",
            "--block-size", "128", "--max-seq-len", "2048",
            "--prefill-chunk", "256", "--attn-impl", "flash"])
        assert serve_spec(args) == {
            "model": "llama-1b", "port": 9001, "bind": "127.0.0.1",
            "max_slots": 8, "block_size": 128, "prefill_chunk": 256,
            "attn_impl": "flash", "platform": "cuda", "max_seq_len": 2048}

    def test_bad_choices_exit(self):
        with pytest.raises(SystemExit):
            _parser().parse_args(["serve", "--platform", "tpu"])
        with pytest.raises(SystemExit):
            _parser().parse_args(["serve", "--attn-impl", "dense"])


class TestServeProcess:
    def test_cli_serves_then_drains_on_sigterm(self, tmp_path):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = str(ROOT)
        proc = subprocess.Popen(
            [sys.executable, "-m", "polyaxon_tpu_torch", "serve", "-m",
             "llama-tiny", "--port", "0", "--block-size", "8",
             "--max-seq-len", "64", "--prefill-chunk", "16",
             "--attn-impl", "flash", "--platform", "cpu"],
            cwd=tmp_path, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        try:
            line = proc.stdout.readline()
            serving = json.loads(line)["serving"]
            assert serving["device"] == "cpu" and serving["attn_impl"] == "flash"
            base = f"http://127.0.0.1:{serving['port']}"
            deadline = time.monotonic() + 60
            while _get(base + "/healthz")[0] != 200:
                assert time.monotonic() < deadline, "never became ready"
                time.sleep(0.1)
            status, body, _ = _post(base + "/generate",
                                    {"prompt": "hi", "max_new_tokens": 3})
            assert status == 200 and len(json.loads(body)["tokens"]) == 3
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=30) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
            proc.stdout.close()
            proc.stderr.close()


    def test_module_entry_serves_the_env_spec_speculatively(self, tmp_path):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(PYTHONPATH=str(ROOT), PLX_SERVE_SPEC=json.dumps(
            {**TINY_SPEC, "port": 0, "speculative": {"draft": "llama-tiny", "k": 3}}))
        proc = subprocess.Popen(
            [sys.executable, "-m", "polyaxon_tpu_torch.serve.runtime"],
            cwd=tmp_path, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        try:
            serving = json.loads(proc.stdout.readline())["serving"]
            base = f"http://127.0.0.1:{serving['port']}"
            deadline = time.monotonic() + 60
            while _get(base + "/healthz")[0] != 200:
                assert time.monotonic() < deadline, "never became ready"
                time.sleep(0.1)
            status, body, _ = _post(base + "/generate",
                                    {"prompt": "hi", "max_new_tokens": 5})
            assert status == 200 and len(json.loads(body)["tokens"]) == 5
            stats = json.loads(_get(base + "/stats")[1])
            # the draft is the target itself: every proposal is accepted
            assert stats["spec_tokens_accepted"] == stats["spec_tokens_proposed"] > 0
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=30) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
            proc.stdout.close()
            proc.stderr.close()
        env.pop("PLX_SERVE_SPEC")
        missing = subprocess.run([sys.executable, "-m", "polyaxon_tpu_torch.serve.runtime"],
                                 cwd=tmp_path, env=env, capture_output=True, text=True,
                                 timeout=60)
        assert missing.returncode != 0 and "PLX_SERVE_SPEC not set" in missing.stderr


class TestChipSmokeRehearsal:
    """chip_smoke.py's main-path phases, at llama-tiny size on the CPU: the
    same concurrent requests, the same staggered prefix sharer, the same
    flash-vs-gather comparison. (The kernel's launch count is a CUDA-only
    check; on the CPU the flash path is the plain version.)"""

    def test_serve_and_compare_phases(self, monkeypatch):
        sys.path.insert(0, str(ROOT))
        try:
            import chip_smoke
        finally:
            sys.path.remove(str(ROOT))
        monkeypatch.setattr(chip_smoke, "PROMPT_LENGTHS",
                            (10, 23, 40, 55, 30, 17, 9, 50))
        monkeypatch.setattr(chip_smoke, "SHARED_PREFIX", 16)
        spec = {**TINY_SPEC, "max_slots": 8, "max_seq_len": 128}
        out = chip_smoke.serve_phase(torch, spec, chip_smoke.make_prompts(256), 6)
        engine = out.pop("engine")
        assert out["decode_steps"] > 0 and out["launches"] == 0
        assert out["prefix_cache_hits"] >= 2 and out["kv_audit_violations"] == 0
        cmp = chip_smoke.compare_phase(torch, engine, lengths=(1, 7, 8, 9, 60),
                                       timed_steps=1)
        # f32 on the CPU: the plain version and gather agree to f32 noise
        assert cmp["max_logit_diff"] < 1e-5

    def test_spec_phase(self, monkeypatch):
        """The spec phase at llama-tiny with itself as the draft: every
        proposal accepted, every row's tokens back, no audit violation."""
        sys.path.insert(0, str(ROOT))
        try:
            import chip_smoke
        finally:
            sys.path.remove(str(ROOT))
        monkeypatch.setattr(chip_smoke, "PROMPT_LENGTHS", (10, 23, 40, 55))
        monkeypatch.setattr(chip_smoke, "SHARED_PREFIX", 8)
        spec = {**TINY_SPEC, "max_slots": 4, "max_seq_len": 128,
                "speculative": {"draft": "llama-tiny", "k": 3}}
        out = chip_smoke.spec_phase(torch, spec, chip_smoke.make_prompts(256), 6)
        assert out["iterations"] > 0 and out["launches"] == 0
        assert out["acceptance"] == 1.0 and out["kv_audit_violations"] == 0
        assert out["timed_rows"] == 4 and len(out["iteration_host_ms"]) == 8

    def test_bridge_phases(self, monkeypatch):
        """The bridge phases at llama-tiny on the CPU: the recorder gets the
        statuses, progress beats and outputs of a training run and the
        serve beats of a replica whose drain marker closes and reopens
        admission while its requests finish; a profile trace is written.
        (Launch counts, MFU and the GPU's memory samples are the card's.)"""
        sys.path.insert(0, str(ROOT))
        try:
            import chip_smoke
        finally:
            sys.path.remove(str(ROOT))
        fa = __import__("importlib").import_module("polyaxon_tpu_torch.ops.flash_attention")
        train = {"model": "llama-tiny", "platform": "cpu", "steps": 3, "batch_size": 2,
                 "seq_len": 32, "checkpoint": False, "log_interval": 1}
        out = chip_smoke.bridge_train_phase(torch, fa, train)
        assert out["statuses"] == ["running", "succeeded"] and out["progress_steps"][-1] == 3
        assert out["outputs_tokens_per_sec_per_chip"] == out["final_tokens_per_sec_per_chip"] > 0
        assert out["gpu0_mem_gib_samples"] == 0 and out["bridge_host_s"] > 0
        monkeypatch.setattr(chip_smoke, "PROMPT_LENGTHS", (10, 23, 40, 55))
        monkeypatch.setattr(chip_smoke, "SHARED_PREFIX", 8)
        monkeypatch.setattr(chip_smoke, "BRIDGE_SERVE_KEYS",
                            {**chip_smoke.BRIDGE_SERVE_KEYS, "report_interval": 0.02})
        # a decode iteration as slow as the card's llama-1b step (~25 ms), so
        # that the requests are still decoding when the marker is read
        from polyaxon_tpu_torch.serve.engine import ServeEngine

        step = ServeEngine.step
        monkeypatch.setattr(ServeEngine, "step",
                            lambda self: (time.sleep(0.025), step(self))[1])
        spec = {**TINY_SPEC, "max_slots": 4, "max_seq_len": 256, "warmup": True}
        out = chip_smoke.bridge_serve_phase(torch, spec, chip_smoke.make_prompts(256), 64)
        assert out["requests_done"] == 4 and out["in_flight_at_503"] > 0
        assert out["new_request_during_drain"] == 503 and out["draining_beats"] > 0
        assert out["decode_steps"] > 0 and out["launches"] == 0
        out = chip_smoke.bridge_profile_phase(torch, train)
        assert out["trace_bytes"] > 0 and out["lineage"] == ["profile"]
