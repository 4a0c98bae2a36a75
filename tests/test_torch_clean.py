"""The port stands alone: no module of ``polyaxon_tpu_torch`` (nor
``chip_smoke.py``) imports JAX, its relatives, anything of the JAX
package, or the libraries the card's machine lacks (pydantic, requests,
aiohttp) — by an AST scan of every source, and by fresh interpreters that
build and run a CPU engine, a training run and the control-plane bridge
with none of them in ``sys.modules``."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "polyaxon_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "optax", "flax", "orbax", "polyaxon_tpu",
             "pydantic", "requests", "aiohttp")


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_the_scan_sees_every_port_module():
    names = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    for expected in ("ops/paged_attention.py", "serve/engine.py",
                     "serve/server.py", "models/transformer.py", "convert.py",
                     "ops/flash_attention.py", "ops/attention.py", "train/trainer.py",
                     "train/optimizers.py", "train/watchdog.py", "runtime/builtin.py",
                     "train/checkpoint.py", "partition/__init__.py", "partition/rules.py",
                     "partition/convert.py", "models/gpt2.py",
                     "resilience/retry.py", "resilience/chaos.py", "tracking/events.py",
                     "tracking/writer.py", "tracking/spool.py", "tracking/client.py",
                     "tracking/run.py", "tracking/__init__.py", "tracking/resources.py",
                     "obs/history.py", "parallel/__init__.py", "parallel/distributed.py",
                     "parallel/mesh.py", "parallel/collectives.py", "parallel/fsdp.py",
                     "ops/ring_attention.py", "ops/ulysses.py", "ops/gating.py",
                     "parallel/pipeline.py", "partition/builtins.py", "partition/lora.py",
                     "partition/plan.py", "partition/__main__.py"):
        assert expected in names


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_a_cpu_engine_runs_without_jax_in_sys_modules(tmp_path):
    code = """
import json, sys
import polyaxon_tpu_torch
from polyaxon_tpu_torch.serve.runtime import build_engine
from polyaxon_tpu_torch.serve.engine import SamplingParams
from polyaxon_tpu_torch.serve.server import build_server
engine = build_engine({"model": "llama-tiny", "platform": "cpu", "block_size": 8,
                       "max_seq_len": 64, "prefill_chunk": 16, "attn_impl": "flash"})
srv = build_server(engine)
srv.server_close()
engine.start()
req = engine.generate([1, 2, 3], SamplingParams(max_new_tokens=3), timeout=60)
engine.stop()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax", "flax", "orbax",
                                    "polyaxon_tpu"))
print(json.dumps({"tokens": req.out_tokens, "bad": bad}))
"""
    # PYTHONPATH is the repository alone: an image whose site directory
    # pre-imports jax must not leak it into this interpreter
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=90)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(out["tokens"]) == 3
    assert out["bad"] == []


def test_a_cpu_training_run_runs_without_jax_in_sys_modules(tmp_path):
    code = """
import json, sys
from polyaxon_tpu_torch.runtime.builtin import run_builtin
run_builtin({"model": "llama-tiny", "platform": "cpu", "checkpoint": False, "steps": 2,
             "batch_size": 2, "seq_len": 128, "remat": "attn_qkv", "watchdog": False})
run_builtin({"model": "llama-moe-tiny", "platform": "cpu", "checkpoint": False, "steps": 2,
             "batch_size": 2, "seq_len": 32, "moe_cap_block": 4, "watchdog": False})
run_builtin({"model": "llama-tiny", "platform": "cpu", "checkpoint": False, "steps": 2,
             "batch_size": 2, "seq_len": 32, "watchdog": False, "lora": {"rank": 4},
             "partition_rules": [["embed/tokens$", [None, "fsdp"]]]})
from polyaxon_tpu_torch.partition.__main__ import main
assert main(["llama-tiny", "vit-tiny", "resnet18-cifar"]) == 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax", "flax", "orbax",
                                    "polyaxon_tpu"))
print(json.dumps({"bad": bad}))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=90)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1])["bad"] == []


def test_cpu_speculative_serving_and_checkpoint_restore_run_without_jax(tmp_path):
    code = """
import json, os, sys
from polyaxon_tpu_torch.runtime.builtin import run_builtin
from polyaxon_tpu_torch.serve.runtime import build_engine
from polyaxon_tpu_torch.serve.engine import SamplingParams
from polyaxon_tpu_torch.partition.convert import export_hf_llama
run_builtin({"model": "llama-tiny", "platform": "cpu", "steps": 2, "batch_size": 2,
             "seq_len": 32, "watchdog": False, "checkpoint": {"save_interval_steps": 1}})
base = {"model": "llama-tiny", "platform": "cpu", "block_size": 8, "max_seq_len": 64,
        "prefill_chunk": 16}
ck = os.path.join(os.environ["PLX_ARTIFACTS_PATH"], "outputs", "checkpoints")
restored = build_engine({**base, "checkpoint": ck,
                         "speculative": {"draft": "llama-tiny", "k": 3}})
export_hf_llama(restored.params, restored.cfg, "hf")
imported = build_engine({**base, "import": {"path": "hf", "layout": "hf-llama"}})
out = []
for engine in (restored, imported):
    engine.start()
    out.append(engine.generate([1, 2, 3], SamplingParams(max_new_tokens=4), timeout=60).out_tokens)
    engine.stop()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax", "flax", "orbax",
                                    "polyaxon_tpu", "safetensors", "ml_dtypes"))
print(json.dumps({"tokens": out, "step": restored.provenance["restored_step"],
                  "bad": bad}))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT), PLX_ARTIFACTS_PATH=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=90)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["step"] == 2 and out["bad"] == []
    assert len(out["tokens"][0]) == 4 and out["tokens"][0] == out["tokens"][1]


def test_the_bridge_runs_without_jax_pydantic_requests_or_aiohttp(tmp_path):
    """A tracked training run and a tracked replica, both reporting to a
    stdlib stub of the API: statuses, heartbeats and outputs arrive, and
    the interpreter never loaded any forbidden module."""
    code = """
import json, os, sys, threading, time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
seen = []
class H(BaseHTTPRequestHandler):
    def do_POST(self):
        n = int(self.headers.get("Content-Length") or 0)
        seen.append(self.path.rsplit("/", 1)[-1])
        self.rfile.read(n)
        self.send_response(200)
        self.send_header("Content-Length", "2")
        self.end_headers()
        self.wfile.write(b"{}")
    def log_message(self, *a):
        pass
srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
threading.Thread(target=srv.serve_forever, daemon=True).start()
os.environ.update(PLX_API_HOST=f"http://127.0.0.1:{srv.server_address[1]}",
                  PLX_RUN_UUID="u", PLX_ARTIFACTS_PATH=os.getcwd())
from polyaxon_tpu_torch.runtime.builtin import run_builtin
from polyaxon_tpu_torch.serve.runtime import start_replica
run_builtin({"model": "llama-tiny", "platform": "cpu", "steps": 2, "batch_size": 2,
             "seq_len": 32, "watchdog": False, "progress_interval": 0})
rep = start_replica({"model": "llama-tiny", "platform": "cpu", "port": 0, "block_size": 8,
                     "max_seq_len": 64, "prefill_chunk": 16, "report_interval": 0.05})
time.sleep(0.3)
rep.close()
rep.run.end()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax", "flax", "orbax",
                                    "polyaxon_tpu", "pydantic", "requests", "aiohttp"))
print(json.dumps({"verbs": sorted(set(seen)), "bad": bad}))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    assert out["verbs"] == ["heartbeat", "lineage", "outputs", "statuses"]
