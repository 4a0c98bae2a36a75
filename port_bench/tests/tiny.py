"""A copy of the benchmark's folder with two tiny cells added as files and
manifest entries (the port's ``bert-tiny`` and ``gpt2-tiny`` presets, f32,
dense attention), which the CPU tests run the harness on."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TINY = {"vocab_size": 256, "hidden_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 4, "intermediate_size": 128, "max_position_embeddings": 128,
        "activation_dtype": "float32"}
CELLS = {"bert-tiny.mlm-s64": ("bert-tiny", "bert-base", "mlm"),
         "gpt2-tiny.lm-s64": ("gpt2-tiny", "gpt2-345m", "lm")}
LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "update_gap": 1e-2}


def make_root(dst: Path) -> Path:
    dst = Path(dst)
    shutil.copytree(REPO / "port_bench", dst / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for cell, (name, like, objective) in CELLS.items():
        conf = json.loads((REPO / f"port_bench/configs/{like}.json").read_text())
        conf.update(TINY, name=name, preset=name)
        conf["runtime"] = dict(conf["runtime"], model=name)
        (dst / f"port_bench/configs/{name}.json").write_text(json.dumps(conf))
        bench["configs"].append({"name": name, "source": "https://example.org/tiny",
                                 "file": f"port_bench/configs/{name}.json", "reduced": [],
                                 "why": "a CPU test's"})
        traffic = f"{objective}-s64"
        work = {"name": cell, "config": name, "traffic": traffic, "objective": objective,
                "traffic_params": {"batch_size": 8, "seq_len": 64, "pool": 4, "mask_rate": 0.15,
                                   "mask_share": 0.8, "random_share": 0.1},
                "runtime": {"checkpoint": False, "microbatches": 2}, "profile_steps": 2,
                "reference_block_tokens": 128, "limits": LIMITS}
        (dst / f"port_bench/workloads/{cell}.json").write_text(json.dumps(work))
        bench["workloads"].append({"name": cell, "config": name, "traffic": traffic,
                                   "chips": 1, "why": "a CPU test's"})
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst
