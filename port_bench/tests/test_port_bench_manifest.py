"""BENCHMARK.json against the benchmark's contract, every cell's files
found by name, and a cell and a metric added as files and entries alone."""

from __future__ import annotations

import json
import math
import re
import types

import pytest

from port_bench import manifest
from port_bench.tests.tiny import REPO, make_root

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_command_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for path in BENCH["paths"]:
        assert PATH.match(path) and not path.startswith("/") and ".." not in path
        assert not path.endswith("_torch")
    assert len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_a_full_check_with_24_cells_fits_its_time():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_lines():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names += [m["name"] for m in metrics]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["why"]) and _line(c["source"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"]) and NAME.match(w["traffic"])
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == \
        len(BENCH["workloads"])


def test_metrics_bounds_and_moves():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        reporting = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m.get("workloads", reporting)) <= reporting
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in cells:
        reported = [m for m in BENCH["end_to_end"] if w in m.get("workloads", cells)]
        assert {"setup_s"} < {m["name"] for m in reported}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files_by_name(cell):
    found = manifest.resolve(cell)
    conf = next(c for c in BENCH["configs"] if c["name"] == found.workload["config"])
    assert found.config["name"] == conf["name"] and found.config["reduced"] == conf["reduced"]
    assert found.config["source"] == conf["source"]
    assert callable(found.traffic.make_pool) and callable(found.reference.train)
    assert callable(found.counts.step_flops)
    assert {m["name"] for m in found.end_to_end} == {"train_tokens_per_s", "setup_s"}
    assert set(found.readers) == {m["name"] for m in BENCH["per_layer"]}
    for key in ("loss_gap", "grad_gap", "update_gap"):
        assert key in found.workload["limits"]


def test_a_cell_and_a_metric_added_as_files_are_found(tmp_path):
    root = make_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "steps.window", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "whole step",
                               "moves": "train_tokens_per_s",
                               "workloads": ["bert-tiny.mlm-s64"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "port_bench/metrics/steps.window.py").write_text(
        "def read(ctx):\n    return ctx.window['steps'] or None\n")
    cell = manifest.resolve("bert-tiny.mlm-s64", root)
    entry, reader = cell.readers["steps.window"]
    assert entry["unit"] == "steps"
    assert reader.read(types.SimpleNamespace(window={"steps": 7})) == 7
    assert "steps.window" not in manifest.resolve("gpt2-tiny.lm-s64", root).readers


def test_the_limits_are_set():
    for w in BENCH["workloads"]:
        limits = manifest.resolve(w["name"]).workload["limits"]
        assert all(isinstance(v, float) and math.isfinite(v) and v > 0
                   for v in limits.values()), (w["name"], limits)


def test_a_family_without_its_layout_is_refused(tmp_path):
    root = make_root(tmp_path)
    (root / "port_bench/layouts/llama.py").unlink()
    with pytest.raises(FileNotFoundError, match="layout"):
        manifest.resolve("llama-tiny.lm-s64", root)
    assert manifest.resolve("gpt2-tiny.lm-s64", root).layout.layout
