"""The pipeline's bubble gate against the ungated schedule, over stage ranks.

    torchrun --nproc-per-node N -m polyaxon_tpu_torch.scripts.pp_bench [--steps 6]
        [--platform cuda|cpu]

The port's twin of the repository's ``scripts/pp_bench.py``. A llama-tiny
widened so that its matmuls outweigh the schedule's machinery (hidden 256,
8 heads over 8 kv heads, mlp 1024, 4 layers, max_seq 128, 2 pipeline
microbatches; f32, dense attention, so no flash kernel runs) computes
``apply_hidden(params, tokens).float().mean()`` and its grads over a GPipe
trunk cut across the ``stage`` ranks, first with ``pp_gate: none``, then
with ``auto`` (``inner`` under model, context or experts, else ``full``):
one warm step, then ``--steps`` timed steps, each synced.

The mesh is the JAX script's ``{stage: 2, model: 2, data: 2}`` at 8
ranks, cut to ``{stage: 2, model: 2}`` at 4 and ``{stage: 2}`` at 2; the
ranks come from ``torchrun`` or the ``PLX_*`` env (NCCL on cuda, one GPU a
rank; gloo on the CPU). A lone process exits non-zero: the pipeline needs
stage ranks. The params are the port's init from seed 0, built through each
rank's blocks; the tokens ``(8, 128)`` come from a ``torch.Generator``
seeded 1.

Rank 0 prints ``{"gate", "step_ms", "loss", "resolved_gate"}`` for each
gate, then ``{"gated_over_ungated", "bubble_fraction", "note", "mesh"}``
with the bubble (S-1)/(M+S-1) of S stages and M microbatches. The two
losses must agree within 1e-6, as the JAX script asserts.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import replace
from typing import Optional

import torch

from ..bench import require_platform

#: the mesh at each world size: the JAX script's at 8 ranks, cut below it
MESHES = {8: {"stage": 2, "model": 2, "data": 2}, 4: {"stage": 2, "model": 2},
          2: {"stage": 2}}
GATES = ("none", "auto")
TOKENS = (8, 128)
#: the two gates' losses, the JAX script's assert
LOSS_AGREE = 1e-6


def bench_config():
    """The JAX script's model: llama-tiny widened, 2 pipeline microbatches."""
    from ..models import llama

    return replace(llama.LLAMA_TINY, hidden=256, num_heads=8, num_kv_heads=8, mlp_dim=1024,
                   num_layers=4, max_seq=128, pp_microbatches=2)


def mesh_for(world: int) -> dict:
    if world not in MESHES:
        raise ValueError(
            f"pp_bench needs stage ranks: run it as 2, 4 or 8 processes (torchrun or "
            f"the PLX_* env), got {world}; its meshes are "
            + ", ".join(f"{w}: {m}" for w, m in sorted(MESHES.items())))
    return dict(MESHES[world])


def make_tokens(vocab_size: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(1)
    return torch.randint(0, vocab_size, TOKENS, generator=gen)


class _Step:
    """One forward and backward of the bench's loss on this rank's blocks
    and rows: the loss over every rank, and each leaf's grad block summed
    over the token ranks as the trainer sums it."""

    def __init__(self, cfg, trainer, params: dict, tokens: torch.Tensor):
        from ..models.transformer import flatten
        from ..parallel.mesh import BATCH_AXES

        self.cfg, self.mesh = cfg, trainer.mesh
        placement = trainer.placement()
        self.tree_paths = [p for p, _ in flatten(params)]
        self.paths = ["/".join(p) for p in self.tree_paths]
        self.cuts = [placement.leaf_cuts(p) for p in self.paths]
        self.leaves = [t for _, t in flatten(params)]
        b = tokens.shape[0] // self.mesh.axis_size(*BATCH_AXES)
        r0 = self.mesh.index(BATCH_AXES) * b
        self.tokens = tokens[r0:r0 + b].to(self.leaves[0].device)
        self.count = tokens.numel() * cfg.hidden

    def __call__(self) -> tuple:
        from ..models import transformer
        from ..parallel.mesh import TOKEN_AXES, grad_sum_axes

        diff = [t.detach().requires_grad_() for t in self.leaves]
        tree = transformer.unflatten(self.tree_paths, diff)
        hidden = transformer.apply_hidden(tree, self.tokens, self.cfg, mesh=self.mesh)
        loss = hidden.float().sum() / self.count
        grads = torch.autograd.grad(loss, diff, allow_unused=True, materialize_grads=True)
        out = []
        for g, cuts in zip(grads, self.cuts):
            g = g.contiguous()
            self.mesh.sum_(g, *grad_sum_axes([a for a, _ in cuts]))
            out.append(g)
        total = loss.detach().reshape(1).clone()
        self.mesh.sum_(total, *TOKEN_AXES)
        return total, out


def _time_steps(step: _Step, steps: int) -> tuple:
    """(the loss, the grads, mean ms of ``steps`` synced steps after a warm
    one)."""
    loss, grads = step()
    float(loss)
    t0 = time.perf_counter()
    for _ in range(steps):
        loss, grads = step()
        if loss.is_cuda:
            torch.cuda.synchronize(loss.device)
        float(loss)
    return float(loss), grads, (time.perf_counter() - t0) / steps * 1000.0


def run_pp_bench(*, steps: int = 6, platform: str = "cuda", params: Optional[dict] = None,
                 tokens: Optional[torch.Tensor] = None) -> dict:
    """Both gates' lines and the summary line; with them this rank's grad
    blocks of each gate's last step (by path), their cuts and the rank's
    coordinates. ``params`` (a whole tree, every rank's alike) and
    ``tokens`` replace the seeded init and draw. Joins the env's process
    group first (and leaves a group it joined)."""
    from .. import parallel
    from ..models.transformer import flatten, resolve_pp_gate, unflatten
    from ..runtime.builtin import resolve_device
    from ..train import Trainer, TrainerConfig

    device = resolve_device({"platform": platform})
    info = parallel.process_info_from_env()
    dist = torch.distributed
    world = (dist.get_world_size() if dist.is_available() and dist.is_initialized()
             else info.num_processes)
    axes = mesh_for(world)
    lines, grads = {}, {}
    with parallel.joined_group(device):
        cfg = bench_config()
        trainer = Trainer(TrainerConfig(model=cfg, batch_size=TOKENS[0], seq_len=TOKENS[1],
                                        parallelism=axes), device=device)
        if params is None:
            blocks = trainer.init_params(0)
        else:
            place = trainer.placement()
            paths, leaves = zip(*flatten(params))
            blocks = unflatten(paths, [
                trainer.mesh.shard(t.to(device), place.leaf_cuts("/".join(p)))
                for p, t in zip(paths, leaves)])
        if tokens is None:
            tokens = make_tokens(cfg.vocab_size)
        for gate in GATES:
            step = _Step(replace(cfg, pp_gate=gate), trainer, blocks, tokens)
            loss, g, ms = _time_steps(step, steps)
            lines[gate] = {"gate": gate, "step_ms": ms, "loss": loss,
                           "resolved_gate": resolve_pp_gate(step.cfg, trainer.mesh)}
            grads[gate] = dict(zip(step.paths, g))
        cuts = {p: [list(c) for c in cs] for p, cs in zip(step.paths, step.cuts)}
        coords = trainer.mesh.coords()
    none, auto = lines["none"], lines["auto"]
    if not abs(none["loss"] - auto["loss"]) < LOSS_AGREE:
        raise AssertionError(f"the gated loss {auto['loss']} differs from the ungated "
                             f"{none['loss']} by more than {LOSS_AGREE}")
    stages, micro = axes["stage"], cfg.pp_microbatches
    summary = {
        "gated_over_ungated": auto["step_ms"] / none["step_ms"],
        "bubble_fraction": (stages - 1) / (micro + stages - 1),
        "note": f"PP fwd+bwd step over {json.dumps(axes)}, M={micro} microbatches, "
                f"{device.type}; identical loss",
        "mesh": axes,
    }
    return {"lines": [none, auto], "summary": summary, "grads": grads, "cuts": cuts,
            "coords": coords}


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m polyaxon_tpu_torch.scripts.pp_bench")
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    return p


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    require_platform(args.platform)
    try:
        result = run_pp_bench(steps=args.steps, platform=args.platform)
    except ValueError as e:
        raise SystemExit(str(e))
    from .. import parallel

    if parallel.process_info_from_env().is_coordinator:
        for line in result["lines"] + [result["summary"]]:
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
