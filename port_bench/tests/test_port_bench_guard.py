"""Nothing the harness loads is JAX or the JAX package (top-level names
compared whole), the references import nothing of the program, and the
command prints no result where it cannot run."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

from port_bench import guard
from port_bench.tests.tiny import REPO

BENCH_DIR = REPO / "port_bench"


def test_top_level_names_are_compared_whole():
    assert guard.loaded_forbidden(["polyaxon_tpu_torch", "polyaxon_tpu_torch.train",
                                   "jaxtyping", "flax_like"]) == []
    assert guard.loaded_forbidden(["polyaxon_tpu", "polyaxon_tpu.ops", "jax.numpy",
                                   "jaxlib", "flax"]) == [
        "flax", "jax.numpy", "jaxlib", "polyaxon_tpu", "polyaxon_tpu.ops"]


def test_no_benchmark_file_imports_jax_and_no_reference_imports_the_program():
    for path in BENCH_DIR.rglob("*.py"):
        tops = guard.imported_tops(path)
        assert not tops & guard.FORBIDDEN, (path, tops)
        if path.parent.name == "reference":
            assert guard.PROGRAM not in tops, path
            assert "polyaxon_tpu_torch" not in path.read_text(), path


def _alone(code: str, cwd) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(cwd), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, *code], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_what_a_run_loads_holds_no_jax_module():
    code = ("import sys, json\n"
            "from port_bench import harness, manifest, run, calibrate\n"
            "bench = manifest.load_manifest()\n"
            "cells = [manifest.resolve(w['name']) for w in bench['workloads']]\n"
            "import polyaxon_tpu_torch.runtime.builtin, polyaxon_tpu_torch.train\n"
            "from port_bench import guard\n"
            "print(json.dumps(guard.loaded_forbidden()))\n")
    out = _alone(["-c", code], REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_or_the_program_the_command_prints_no_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (REPO, tmp_path):
        out = _alone(["-m", "port_bench.run", "--workload", "bert-base.mlm-s512",
                      "--seed", "1", "--seconds", "1", "--trace", "0"], cwd)
        assert out.returncode != 0 and out.stdout == "", (cwd, out.stdout)
