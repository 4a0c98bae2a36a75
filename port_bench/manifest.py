"""Finds everything a cell needs by the names in ``BENCHMARK.json``.

- a configuration ``<c>``: ``configs/<c>.json`` (sizes, the port's preset,
  the example's runtime keys, ``family`` and ``counts``);
- its family's files: ``layouts/<family>.py`` (``layout``: each weight's
  path, shape, scale, offset and whether it is layer-stacked; ``stated``:
  the program's configuration under the file's keys, which the harness
  checks), ``reference/<family>.py`` (``train``: the plain reference, a
  model handed to ``reference/core.py``'s step loop);
- its operation counts: ``counts/<counts>.py`` (``step_flops``,
  ``flash_least_s``);
- a cell ``<w>``: ``workloads/<w>.json`` (the traffic's parameters, the
  runtime keys the cell changes, the limits of the comparison);
- the traffic's generator: ``traffic/<objective>.py`` (``make_pool``,
  ``loss_tokens``);
- a per-layer metric ``<m>``: ``metrics/<m>.py`` (``read(ctx)``).

A later cell, configuration, family or metric is new files and new entries:
a family brings its layout, reference and counts, a configuration its
file and a ``configs`` entry, a cell its workload file (and a traffic file
where its objective is new) and a ``workloads`` entry. No file here
changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _load(path: Path, kind: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    name = "port_bench._" + kind + "_" + re.sub(r"\W", "_", path.stem)
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    workload: dict
    traffic: ModuleType
    layout: ModuleType
    reference: ModuleType
    counts: ModuleType
    end_to_end: list
    readers: dict = field(default_factory=dict)   # metric name -> (entry, module)


def load_manifest(root: Path = ROOT) -> dict:
    return _json(Path(root) / "BENCHMARK.json")


def resolve(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its files loaded (raises when one is
    missing)."""
    root = Path(root)
    bench = load_manifest(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    entry = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    conf_entry = configs[entry["config"]]
    base = root / "port_bench"
    config = _json(root / conf_entry["file"])
    workload = _json(base / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if workload[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json names {key} {workload[key]!r}, "
                             f"BENCHMARK.json {entry[key]!r}")
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    readers = {}
    for metric in bench["per_layer"]:
        if name in metric.get("workloads", [name] if metric["moves"] in reported else []):
            readers[metric["name"]] = (metric, _load(base / "metrics" / f"{metric['name']}.py",
                                                     "metric"))
    return Cell(
        name=name, chips=int(entry["chips"]), config=config, workload=workload,
        traffic=_load(base / "traffic" / f"{workload['objective']}.py", "traffic"),
        layout=_load(base / "layouts" / f"{config['family']}.py", "layout"),
        reference=_load(base / "reference" / f"{config['family']}.py", "reference"),
        counts=_load(base / "counts" / f"{config['counts']}.py", "counts"),
        end_to_end=e2e, readers=readers)
