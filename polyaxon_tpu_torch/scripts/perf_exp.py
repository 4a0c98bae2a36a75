"""Training perf experiments of the port: one config, one JSON line.

    python -m polyaxon_tpu_torch.scripts.perf_exp MODEL BATCH SEQ REMAT [STEPS]
        [--profile DIR] [--mu-bf16] [--nu-bf16] [--grad-bf16] [--accum-bf16]
        [--chunk N] [--micro N] [--dispatch capacity|a2a|dense] [--block N]
        [--bq N] [--bk N] [--bq-bwd N] [--bk-bwd N] [--cap-block N]
        [--platform cuda|cpu]

Runs the port's Trainer on a Llama config (``models/llama.py``'s names)
over ``{data: world size}`` and prints the keys of the repository's
``scripts/perf_exp.py``: tokens/s/chip, step time and MFU against the
H100's peak, so configs can be swept from the shell. ``--profile DIR``
runs 3 steps, then steps 3-5 under ``torch.profiler``, and writes their
Chrome trace to ``DIR/trace.json``; the line then reads the profiled
steps. Runs on CUDA unless ``--platform cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from dataclasses import replace
from typing import Optional

import torch

from ..bench import require_platform

def run_perf_exp(model: str, batch: int, seq: int, remat: str, steps: int = 12, *,
                 profile_dir: Optional[str] = None, mu_bf16: bool = False,
                 nu_bf16: bool = False, grad_bf16: bool = False, accum_bf16: bool = False,
                 chunk: Optional[int] = None, micro: int = 1,
                 dispatch: Optional[str] = None, block: Optional[int] = None,
                 bq: Optional[int] = None, bk: Optional[int] = None,
                 bq_bwd: Optional[int] = None, bk_bwd: Optional[int] = None,
                 cap_block: Optional[int] = None, platform: str = "cuda") -> dict:
    """Train ``steps`` steps of the config and return the JSON object."""
    from .. import parallel
    from ..models import llama
    from ..runtime.builtin import resolve_device, trainer_batches
    from ..train import OptimizerConfig, Trainer, TrainerConfig

    mcfg = replace(llama.CONFIGS[model], remat=remat, max_seq=seq)
    if dispatch is not None:
        mcfg = replace(mcfg, moe_dispatch=dispatch)
    if chunk is not None:
        mcfg = replace(mcfg, loss_chunk_tokens=chunk)
    if block is not None:
        mcfg = replace(mcfg, attn_block_q=block, attn_block_k=block)
    for field, value in (("attn_block_q", bq), ("attn_block_k", bk),
                         ("attn_block_q_bwd", bq_bwd), ("attn_block_k_bwd", bk_bwd),
                         ("moe_cap_block", cap_block)):
        if value is not None:
            mcfg = replace(mcfg, **{field: int(value)})
    mu_dtype = "bfloat16" if mu_bf16 else None
    nu_dtype = "bfloat16" if nu_bf16 else None
    grad_dtype = "bfloat16" if grad_bf16 else None
    device = resolve_device({"platform": platform})
    n = parallel.process_info_from_env().num_processes
    with parallel.joined_group(device):
        cfg = TrainerConfig(
            model=mcfg,
            optimizer=OptimizerConfig(learning_rate=3e-4, warmup_steps=5, total_steps=steps,
                                      mu_dtype=mu_dtype, nu_dtype=nu_dtype),
            batch_size=batch, seq_len=seq, parallelism={"data": n}, accelerator="h100",
            grad_dtype=grad_dtype, microbatches=micro,
            accum_dtype="bfloat16" if accum_bf16 else None)
        trainer = Trainer(cfg, device=device)
        batches = trainer_batches(trainer, "lm", kind="synthetic-lm",
                                  vocab_size=mcfg.vocab_size)
        if profile_dir:
            state, _ = trainer.fit(batches, num_steps=3)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            with torch.profiler.profile(activities=activities) as prof:
                _, metrics = trainer.fit(batches, num_steps=6, state=state)
            if trainer.primary:
                os.makedirs(profile_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
        else:
            _, metrics = trainer.fit(batches, num_steps=steps)
    return {
        "model": model, "batch": batch, "seq": seq, "remat": remat,
        "mu_bf16": bool(mu_dtype), "nu_bf16": bool(nu_dtype),
        "grad_bf16": bool(grad_dtype), "chunk": chunk, "micro": micro,
        "tokens_per_sec_per_chip": round(metrics["tokens_per_sec_per_chip"], 1),
        "step_time_ms": round(metrics["step_time_ms"], 1),
        "mfu": round(metrics["mfu"], 4),
    }


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m polyaxon_tpu_torch.scripts.perf_exp")
    p.add_argument("model")
    p.add_argument("batch", type=int)
    p.add_argument("seq", type=int)
    p.add_argument("remat")
    p.add_argument("steps", type=int, nargs="?", default=12)
    p.add_argument("--profile", dest="profile_dir", default=None)
    for flag in ("--mu-bf16", "--nu-bf16", "--grad-bf16", "--accum-bf16"):
        p.add_argument(flag, action="store_true")
    p.add_argument("--chunk", type=int, default=None)
    p.add_argument("--micro", type=int, default=1)
    p.add_argument("--dispatch", choices=("capacity", "a2a", "dense"), default=None)
    for flag in ("--block", "--bq", "--bk", "--bq-bwd", "--bk-bwd", "--cap-block"):
        p.add_argument(flag, type=int, default=None)
    p.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    return p


def main(argv=None) -> int:
    args = vars(_parser().parse_intermixed_args(argv))
    require_platform(args["platform"])
    line = run_perf_exp(args.pop("model"), args.pop("batch"), args.pop("seq"),
                        args.pop("remat"), args.pop("steps"), **args)
    from .. import parallel

    if parallel.process_info_from_env().is_coordinator:
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
