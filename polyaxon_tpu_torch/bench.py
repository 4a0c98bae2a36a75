"""Headline benchmark of the port: Llama training throughput on the card.

    python -m polyaxon_tpu_torch.bench [--moe] [--data tokens-file] [--platform cuda|cpu]

Prints ONE JSON line with the keys of the repository's ``bench.py``:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

``vs_baseline`` is the measured MFU / 0.45, the north-star MFU of
``BASELINE.json``; MFU is taken against the H100's dense bf16 peak
(``train/metrics.py``), as ``bench.py`` takes it against its chip's.

The recipe scales with the world size (one process per GPU, from the
``PLX_*`` or ``torchrun`` env; 1 without it), as ``bench.py``'s scales
with its chips:
  (default)          dense Llama: llama-1b on up to 31 GPUs, llama2-7b over
                     fsdp from 32
  --moe              llama-moe-1b, capacity dispatch streamed in cap blocks,
                     the router's drop fraction in the unit
  --data tokens-file the dense recipe fed from a packed uint16 corpus (200 M
                     tokens, written once into the temporary directory)
  --platform cpu     the CPU smoke: llama-tiny (dense attention), 8 x 64, 5
                     steps; without it the run needs a CUDA device

``bench.py --orchestrated`` is not ported: it boots the control plane's
store and agent, which the port does not import (the CPU chains of
``tests/test_torch_orchestrated.py`` drive that path).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from dataclasses import replace
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

#: the north-star MFU of BASELINE.json: vs_baseline = mfu / this
NORTH_STAR_MFU = 0.45
#: the corpus --data tokens-file writes: ~50x the tokens one bench consumes
TOKEN_FILE_TOKENS = 200_000_000
BF16_MOMENTS = {"mu_dtype": "bfloat16", "nu_dtype": "bfloat16"}


class Recipe(NamedTuple):
    """One bench configuration: ``bench.py``'s per-branch choices."""

    model: Any               # the TransformerConfig
    batch: int
    seq: int
    axes: dict
    steps: int
    microbatches: int
    moments: dict            # OptimizerConfig's mu_dtype / nu_dtype
    grad_dtype: Optional[str]
    accum_dtype: Optional[str]


def bench_config(n: int, on_cuda: bool, moe: bool) -> Recipe:
    """The recipe for ``n`` processes (one GPU each), branch by branch as
    ``bench.py`` picks it for ``n`` chips."""
    from .models import llama

    if moe:
        if on_cuda:
            # cap-blocked streaming of the capacity dispatch (blocks of 512),
            # 8 microbatches, bf16 moments, grads and accumulator
            mcfg = replace(llama.LLAMA_MOE_1B, remat="attn_qkv", attn_block_q=1024,
                           attn_block_k=1024, moe_cap_block=512)
            return Recipe(mcfg, 32 * n, 2048, {"data": n}, 8, 8, dict(BF16_MOMENTS),
                          "bfloat16", "bfloat16")
        mcfg = replace(llama.LLAMA_MOE_TINY, attn_impl="dense", moe_cap_block=4)
        return Recipe(mcfg, 8, 64, {"data": min(n, 8)}, 5, 1, {}, None, None)
    if on_cuda and n >= 32:
        # the north-star shape: 7B over fsdp, 4 samples a process
        mcfg = replace(llama.LLAMA2_7B, remat="attn_qkv", attn_block_q=1024,
                       attn_block_k=1024)
        return Recipe(mcfg, 4 * n, 2048, {"fsdp": n}, 20, 2, dict(BF16_MOMENTS),
                      "bfloat16", "bfloat16")
    if on_cuda:
        # ~1.1B (TinyLlama's shape), 32-way accumulation of microbatches of 2
        mcfg = replace(llama.LLAMA_1B, remat="attn_qkv", max_seq=2048, attn_block_q=1024,
                       attn_block_k=1024)
        return Recipe(mcfg, 64 * n, 2048, {"data": n}, 8, 32, dict(BF16_MOMENTS),
                      "bfloat16", "bfloat16")
    mcfg = replace(llama.LLAMA_TINY, attn_impl="dense")
    return Recipe(mcfg, 8, 64, {"data": min(n, 8)}, 5, 1, {}, None, None)


class BenchResult(NamedTuple):
    line: dict               # the printed JSON object
    metrics: dict            # the trainer's final metrics, unrounded
    recipe: Recipe
    steps: int
    chips: int
    flops_per_token: float


def token_file_path(vocab_size: int, directory: Optional[str] = None) -> str:
    return os.path.join(directory or tempfile.gettempdir(),
                        f"plx_bench_tokens_v{vocab_size}.npy")


def token_file(vocab_size: int, tokens: int = TOKEN_FILE_TOKENS,
               directory: Optional[str] = None) -> str:
    """The packed corpus ``--data tokens-file`` streams: ``tokens`` uniform
    ids below ``vocab_size`` in a ``.npy`` (uint16 when the vocab fits),
    the vocab in the name so that another model's file is never read.
    Written once; a file that holds at least ``tokens`` ids is reused."""
    path = token_file_path(vocab_size, directory)
    if os.path.exists(path) and np.load(path, mmap_mode="r").shape[0] >= tokens:
        return path
    rng = np.random.default_rng(0)
    dtype = np.uint16 if vocab_size <= 65536 else np.uint32
    tmp = f"{path}.{os.getpid()}.tmp.npy"
    np.save(tmp, rng.integers(0, vocab_size, tokens, dtype=dtype))
    os.replace(tmp, path)  # other processes see the whole file or none
    return path


def bench_line(recipe: Recipe, metrics: dict, chips: int, moe: bool) -> dict:
    """``bench.py``'s JSON object for these metrics."""
    mcfg, mfu = recipe.model, metrics["mfu"]
    value = round(metrics["tokens_per_sec_per_chip"], 2)
    if moe:
        return {
            "metric": "llama_moe_train_tokens_per_sec_per_chip",
            "value": value,
            "unit": f"tokens/s/chip (model={mcfg.num_params()/1e6:.0f}M total/"
                    f"{mcfg.active_params()/1e6:.0f}M active, E={mcfg.num_experts} "
                    f"top{mcfg.expert_top_k}, seq={recipe.seq}, chips={chips}, "
                    f"mfu={mfu:.3f}, cap_block={mcfg.moe_cap_block}, "
                    f"drop={float(metrics.get('router_drop_frac', 0.0)):.4f})",
            "vs_baseline": round(mfu / NORTH_STAR_MFU, 4),
        }
    return {
        "metric": "llama_train_tokens_per_sec_per_chip",
        "value": value,
        "unit": f"tokens/s/chip (model={mcfg.num_params()/1e6:.0f}M, seq={recipe.seq}, "
                f"chips={chips}, mfu={mfu:.3f})",
        "vs_baseline": round(mfu / NORTH_STAR_MFU, 4),
    }


def run_bench(*, moe: bool = False, data: Optional[str] = None, platform: str = "cuda",
              steps: Optional[int] = None, tokens: int = TOKEN_FILE_TOKENS,
              token_dir: Optional[str] = None,
              track: Optional[Callable[[int, dict], None]] = None) -> BenchResult:
    """Train the recipe for ``steps`` steps (the recipe's own count when
    None) and return its line. The process joins the env's process group
    first and leaves a group it joined. ``data="tokens-file"`` streams a
    corpus of ``tokens`` ids (:func:`token_file`, in ``token_dir`` or the
    temporary directory); ``track(step, metrics)``, when given, receives
    every step's metrics."""
    from . import parallel
    from .runtime.builtin import resolve_device, trainer_batches
    from .train import OptimizerConfig, Trainer, TrainerConfig

    if data not in (None, "tokens-file"):
        raise ValueError(f"data takes 'tokens-file', got {data!r}")
    device = resolve_device({"platform": platform})
    info = parallel.process_info_from_env()
    recipe = bench_config(info.num_processes, device.type == "cuda", moe)
    steps = recipe.steps if steps is None else int(steps)
    with parallel.joined_group(device):
        cfg = TrainerConfig(
            model=recipe.model,
            optimizer=OptimizerConfig(learning_rate=3e-4, warmup_steps=5, total_steps=steps,
                                      **recipe.moments),
            batch_size=recipe.batch, seq_len=recipe.seq, parallelism=recipe.axes,
            accelerator="h100", grad_dtype=recipe.grad_dtype,
            microbatches=recipe.microbatches, accum_dtype=recipe.accum_dtype,
            log_interval=1 if track is not None else 10)
        trainer = Trainer(cfg, device=device, track=track)
        vocab = recipe.model.vocab_size
        source: dict = {"kind": "synthetic-lm"}
        if data == "tokens-file":
            if trainer.primary:
                token_file(vocab, tokens, token_dir)
            trainer.mesh.barrier()  # the file is whole before any rank maps it
            source = {"kind": "tokens-file", "path": token_file_path(vocab, token_dir)}
        batches = trainer_batches(trainer, "lm", vocab_size=vocab, **source)
        try:
            _, metrics = trainer.fit(batches, num_steps=steps)
        finally:
            close = getattr(batches, "close", None)
            if callable(close):
                close()
        chips = trainer.mesh.size
        flops = trainer.task.flops_per_token(recipe.seq)
    return BenchResult(bench_line(recipe, metrics, chips, moe), metrics, recipe, steps,
                       chips, flops)


def require_platform(platform: str) -> None:
    """Exit non-zero, naming CUDA, when the platform is cuda and no CUDA
    device is usable: a tool never falls back to the CPU."""
    if platform == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no usable CUDA device: this tool runs on CUDA unless "
                         "--platform cpu is given")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m polyaxon_tpu_torch.bench",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--moe", action="store_true", help="the sparse-MoE recipe")
    p.add_argument("--data", choices=("tokens-file",), default=None,
                   help="feed the dense recipe from a packed uint16 corpus")
    p.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--orchestrated", action="store_true",
                   help="not ported (the control plane's store and agent)")
    return p


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.orchestrated:
        print("--orchestrated is not ported: it boots the control plane's store and "
              "agent, which the port does not import", file=sys.stderr)
        return 2
    require_platform(args.platform)
    result = run_bench(moe=args.moe, data=args.data, platform=args.platform)
    from . import parallel

    if parallel.process_info_from_env().is_coordinator:
        print(json.dumps(result.line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
