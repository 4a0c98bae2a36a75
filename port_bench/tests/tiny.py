"""A copy of the benchmark's folder with three tiny cells added as files and
manifest entries (the port's ``bert-tiny``, ``gpt2-tiny`` and
``llama-tiny`` presets, f32, dense attention), which the CPU tests run the
harness on. ``llama-tiny`` is a family no cell of ``BENCHMARK.json`` has:
its layout, reference and counts are the folder's own files, its
configuration and workload files are written here."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TINY = {"vocab_size": 256, "hidden_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 4, "intermediate_size": 128, "max_position_embeddings": 128,
        "activation_dtype": "float32"}
OPTIMIZER = {"name": "adamw", "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1,
             "grad_clip": 1.0, "schedule": "cosine", "min_lr_ratio": 0.1}
# the port's llama-tiny preset (models/llama.py): GQA 4 / 2, RMSNorm,
# SwiGLU, RoPE at theta 10,000, an untied head, no biases
LLAMA_TINY = {
    "name": "llama-tiny", "source": "https://arxiv.org/abs/2307.09288",
    "preset": "llama-tiny", "family": "llama", "counts": "llama",
    "vocab_size": 256, "hidden_size": 64, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2, "intermediate_size": 128,
    "max_position_embeddings": 128, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
    "hidden_act": "silu", "tie_word_embeddings": False, "causal": True,
    "activation_dtype": "float32", "param_dtype": "float32", "optimizer": OPTIMIZER,
    "runtime": {"model": "llama-tiny", "steps": 5000, "batch_size": 8, "seq_len": 64,
                "learning_rate": 3e-4, "data": {"kind": "synthetic-lm"}},
    "reduced": [],
}
# cell -> (configuration, the repo's configuration it shrinks or None, objective)
CELLS = {"bert-tiny.mlm-s64": ("bert-tiny", "bert-base", "mlm"),
         "gpt2-tiny.lm-s64": ("gpt2-tiny", "gpt2-345m", "lm"),
         "llama-tiny.lm-s64": ("llama-tiny", None, "lm")}
LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "update_gap": 1e-2}


def tiny_config(name: str, like) -> dict:
    if like is None:
        return dict(LLAMA_TINY)
    conf = json.loads((REPO / f"port_bench/configs/{like}.json").read_text())
    conf.update(TINY, name=name, preset=name)
    conf["runtime"] = dict(conf["runtime"], model=name)
    return conf


def make_root(dst: Path) -> Path:
    dst = Path(dst)
    shutil.copytree(REPO / "port_bench", dst / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for cell, (name, like, objective) in CELLS.items():
        conf = tiny_config(name, like)
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
