"""The port's builtin training runtime (``polyaxon_tpu_torch.runtime.builtin``)
on the CPU: the llama-tiny run prints the JAX runtime's ``{"final": ...}``
line with the meter's keys, every key the port does not support raises,
and the default platform needs a CUDA device.

Its numbers are held against the JAX package by the trainer parity tests
(``tests/test_torch_train_step.py``); these check the entry point."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from polyaxon_tpu_torch.runtime.builtin import run_builtin

ROOT = Path(__file__).resolve().parents[1]
TINY = {"model": "llama-tiny", "platform": "cpu", "checkpoint": False, "steps": 3,
        "batch_size": 4, "seq_len": 32, "microbatches": 2, "log_interval": 1,
        "watchdog": False}
METER_KEYS = ("steps", "step_time_ms", "step_time_p50_ms", "step_time_p95_ms",
              "tokens_per_sec", "tokens_per_sec_per_chip", "achieved_tflops_per_chip",
              "mfu")


def test_cpu_run_prints_the_final_line_with_the_meter_keys(capsys):
    tracked = []
    summary = run_builtin(dict(TINY), track=lambda step, m: tracked.append(step))
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    final = lines[-1]["final"]
    assert final == json.loads(json.dumps(summary))
    for key in METER_KEYS + ("loss", "grad_norm", "train_anomalies_loss",
                             "train_anomalies_grad", "resumed_from_step"):
        assert key in final, key
    assert final["steps"] == 2 and final["mfu"] is None and final["device"] == "cpu"
    assert [x["step"] for x in lines[:-1]] == [0, 1, 2] == tracked


@pytest.mark.parametrize("key,value,match", [
    ("checkpoint", {"save_interval_steps": 2}, "A4"),
    ("checkpoint", True, "A4"),
    ("import", {"path": "/x"}, "A12"),
    ("lora", {"rank": 4}, "A12"),
    ("parallelism", {"data": 2}, "A6"),
    ("num_slices", 2, "A6"),
    ("profile", True, "A5"),
    ("optimizer", "lion", "A4"),
    ("data", {"kind": "tokens-file", "path": "/x.npy"}, "A4"),
    ("pp_microbatches", 4, "A9"),
    ("moe_dispatch", "a2a", "A10"),
    ("chaos", {"nan_at_step": 1}, "A5"),
    ("partition_rules", [["a", "b"]], "A6"),
    ("anomaly_rollback_budget", 2, "A4"),
    ("unknown_knob", 1, "unknown spec key"),
])
def test_unsupported_keys_raise_naming_their_roadmap_item(key, value, match):
    spec = dict(TINY, **{key: value})
    if key == "checkpoint" and value is True:
        spec.pop("checkpoint")  # absent means the JAX default: checkpoints on
    with pytest.raises(SystemExit, match=match):
        run_builtin(spec)


def test_the_default_platform_needs_a_cuda_device():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    spec = {k: v for k, v in TINY.items() if k != "platform"}
    with pytest.raises(RuntimeError, match="CUDA device"):
        run_builtin(spec)


def test_module_entry_reads_the_spec_and_writes_final_json(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT), PLX_ARTIFACTS_PATH=str(tmp_path),
               PLX_BUILTIN_SPEC=json.dumps(dict(TINY, steps=2)))
    proc = subprocess.run([sys.executable, "-m", "polyaxon_tpu_torch.runtime.builtin"],
                          cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    final = json.loads(proc.stdout.strip().splitlines()[-1])["final"]
    assert json.loads((tmp_path / "outputs" / "final.json").read_text()) == final
    assert final["steps"] == 1
