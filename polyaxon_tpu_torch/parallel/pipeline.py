"""Pipeline parallelism over the ``stage`` axis — counterpart of
``polyaxon_tpu/parallel/pipeline.py``.

The stacked layer dim is cut over the stage ranks: stage i holds layers
``[i*L/S, (i+1)*L/S)``. A GPipe schedule of ``m`` microbatches runs over
``m + S - 1`` ticks; at tick t stage i processes microbatch ``t - i`` (its
rows ``[j*mb, (j+1)*mb)`` of the rank's batch) and hands its output to
stage i+1. The last stage's outputs go to every stage, so the loss (and
every leaf outside the trunk: embedding, final norm, head) is computed
alike on every stage rank.

One :class:`torch.autograd.Function` per trunk call fixes the order of the
point-to-point traffic on every rank. Its forward runs the tick loop and
keeps each tick's autograd graph, or only the tick's input under
``remat_ticks`` (the stage forward is recomputed in the backward: an O(S)
stash in place of O(m)). Its backward runs the ticks in reverse: it takes
the cotangent of the tick's output from the next stage, back-propagates
the tick, and sends the input's cotangent to the previous stage. Leaving
that order to the autograd engine across ranks would invite deadlocks.

Gradients are the stage-free run's, leaf by leaf:

- the last stage takes the cotangent of its outputs from its own loss
  (every stage's loss is the same number; summing the stages' cotangents
  would count it S times);
- the trunk input's cotangent, which only stage 0 computes, goes to every
  stage, so the embedding (and learned positions) get the same grad on
  every stage rank;
- aux (the MoE router's [balance, drop]) is summed over ticks and stages
  and divided by S*m; each stage's layers take its grad from their own
  ticks.

Gates. A tick's activity depends only on (tick, stage index), which every
peer of a model, context or expert group shares, so a group is active or
idle as a whole: under ``full`` and ``inner`` an idle tick is skipped
outright (no body, no exchange). ``none`` is the JAX package's ungated
oracle: every tick runs its body on the carried state (zeros before the
first arrival), sends on, and its aux is masked.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from .fsdp import ShardedTree, fresh

_dist = torch.distributed


def validate_pipeline_mesh(mesh) -> int:
    """The stage count: every axis composes with ``stage`` (inside a stage
    the MoE layer needs the all-to-all dispatch when ``expert`` > 1, which
    the transformer's pipeline path enforces)."""
    return mesh.pp


def _leaves(tree: Any) -> list:
    if isinstance(tree, ShardedTree):
        return tree.leaves()
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def _with_leaves(tree: Any, leaves: list) -> Any:
    if isinstance(tree, ShardedTree):
        return tree.with_leaves(leaves)
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(tree)


# -- the seams of the schedule's three rules (module functions, so a test can
#    plant a fault in each) -------------------------------------------------------


def _tick_microbatch(t: int, stage: int) -> int:
    """The microbatch stage ``stage`` processes at tick ``t``."""
    return t - stage


def _output_cotangent(g: torch.Tensor, mesh) -> torch.Tensor:
    """The cotangent of the trunk's outputs the last stage back-propagates
    (every stage calls this; only the last reads it): its own, as every
    stage's loss is the same number."""
    return g


def _share_input_cotangent(dx: Optional[torch.Tensor], like: torch.Tensor,
                           mesh) -> torch.Tensor:
    """Stage 0's cotangent of the trunk input, on every stage."""
    out = dx if dx is not None else torch.empty_like(like)
    _dist.broadcast(out, src=mesh.stage_rank(0), group=mesh.group("stage"))
    return out


class _Plan:
    """What one trunk call runs: the body, the layer tree, the mesh and
    the schedule's knobs."""

    def __init__(self, body_fn, tree, mesh, m: int, gate: str, remat_ticks: bool):
        self.body_fn, self.tree, self.mesh = body_fn, tree, mesh
        self.m, self.gate, self.remat_ticks = m, gate, remat_ticks

    def body(self, x, tree, active: bool):
        if self.gate == "inner":
            return self.body_fn(x, fresh(tree), active)
        return self.body_fn(x, fresh(tree))


def _recv(like: torch.Tensor, src: int, group) -> torch.Tensor:
    buf = torch.empty_like(like)
    _dist.irecv(buf, src=src, group=group).wait()
    return buf


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan: _Plan, need_grad: bool, x: torch.Tensor, *leaves):
        mesh, m = plan.mesh, plan.m
        S, i = mesh.pp, mesh.stage_index
        group = mesh.group("stage")
        last = i == S - 1
        b, s, h = x.shape
        mb = b // m
        ticks_total = m + S - 1
        keep_graph = need_grad and not plan.remat_ticks
        params = [p.detach().requires_grad_(p.requires_grad and need_grad) for p in leaves]
        tree = _with_leaves(plan.tree, params)
        xd = x.detach()
        like = xd[:mb]
        outs = xd.new_zeros((m, mb, s, h)) if last else None
        aux_sum = torch.zeros(2, dtype=torch.float32, device=x.device)
        ticks, kept, sends = [], [], []
        for t in range(ticks_total):
            active = 0 <= _tick_microbatch(t, i) < m
            if not active and plan.gate != "none":
                continue
            received = i > 0 and t > 0
            if i == 0:
                j = min(max(_tick_microbatch(t, i), 0), m - 1)
                src = xd[j * mb:(j + 1) * mb]
            elif not received:  # the carried state before any arrival
                src = torch.zeros_like(like)
            else:
                src = _recv(like, mesh.stage_rank(i - 1), group)
            stage_in = src.detach().requires_grad_(keep_graph)
            with torch.set_grad_enabled(keep_graph):
                out, aux = plan.body(stage_in, tree, active)
            if active:
                aux_sum = aux_sum + aux.detach().float()
            sent = not last and t < ticks_total - 1
            if sent:
                payload = out.detach().contiguous()
                sends.append((_dist.isend(payload, dst=mesh.stage_rank(i + 1), group=group),
                              payload))
            if last and active:
                outs[_tick_microbatch(t, i)] = out.detach()
            # the backward mirrors each tick's traffic: a cotangent comes back
            # for what was sent and goes back for what was received
            ticks.append((t, active, received, sent))
            if keep_graph:
                kept.append((stage_in, out, aux))
            elif need_grad:
                kept.append(stage_in.detach())
        for work, _ in sends:
            work.wait()
        full = outs.reshape(b, s, h) if last else torch.empty_like(xd)
        _dist.broadcast(full, src=mesh.stage_rank(S - 1), group=group)
        _dist.all_reduce(aux_sum, group=group)
        ctx.plan, ctx.tree, ctx.params, ctx.ticks = plan, tree, params, ticks
        ctx.x_shape, ctx.x_dtype = xd.shape, xd.dtype
        if plan.remat_ticks and need_grad:
            ctx.save_for_backward(*kept)   # the ticks' inputs, all the stash keeps
            ctx.graphs = None
        else:
            ctx.graphs = kept
        return full, aux_sum / (S * m)

    @staticmethod
    def backward(ctx, g_full, g_aux):
        plan = ctx.plan
        mesh, m = plan.mesh, plan.m
        S, i = mesh.pp, mesh.stage_index
        group = mesh.group("stage")
        last = i == S - 1
        b, s, h = ctx.x_shape
        mb = b // m
        graphs = ctx.graphs if ctx.graphs is not None else list(ctx.saved_tensors)
        params = ctx.params
        want = [p for p in params if p.requires_grad]
        grads: list = [None] * len(want)
        g_outs = _output_cotangent(g_full, mesh).reshape(m, mb, s, h)  # every stage calls it
        g_tick = (g_aux.float() / (S * m)) if g_aux is not None else None
        dx = torch.zeros(ctx.x_shape, dtype=ctx.x_dtype, device=g_full.device) \
            if i == 0 else None
        sends = []
        for (t, active, received, sent), saved in zip(reversed(ctx.ticks), reversed(graphs)):
            if last:
                g_out = g_outs[_tick_microbatch(t, i)] if active else None
            elif sent:
                g_out = _recv(g_full[:mb], mesh.stage_rank(i + 1), group)
            else:
                g_out = None
            if ctx.graphs is None:  # remat_ticks: rerun the tick's stage forward
                stage_in = saved.detach().requires_grad_(True)
                with torch.enable_grad():
                    out, aux = plan.body(stage_in, ctx.tree, active)
            else:
                stage_in, out, aux = saved
            outputs, cots = [], []
            if g_out is not None and out.requires_grad:
                outputs.append(out)
                cots.append(g_out.to(out.dtype))
            if active and g_tick is not None and aux.requires_grad:
                outputs.append(aux)
                cots.append(g_tick.to(aux.dtype))
            d_in = None
            if outputs:
                got = torch.autograd.grad(outputs, [stage_in] + want, cots, allow_unused=True)
                d_in = got[0]
                for n, g in enumerate(got[1:]):
                    if g is not None:
                        grads[n] = g if grads[n] is None else grads[n] + g
            if d_in is None:
                d_in = torch.zeros_like(stage_in)
            if received:
                payload = d_in.detach().contiguous()
                sends.append((_dist.isend(payload, dst=mesh.stage_rank(i - 1), group=group),
                              payload))
            if i == 0:
                j = min(max(_tick_microbatch(t, i), 0), m - 1)
                dx[j * mb:(j + 1) * mb] += d_in.to(dx.dtype)
        for work, _ in sends:
            work.wait()
        dx = _share_input_cotangent(dx, g_full, mesh)
        it = iter(grads)
        out = [next(it) if p.requires_grad else None for p in params]
        ctx.graphs = ctx.tree = ctx.params = None
        return (None, None, dx, *out)


def gpipe_trunk(
    x: torch.Tensor,
    layer_params: Any,
    body_fn: Callable[..., Any],
    mesh,
    *,
    num_microbatches: int = 0,
    gate: str = "full",
    remat_ticks: bool = False,
    num_layers: Optional[int] = None,
) -> tuple:
    """Run this rank's stage of the trunk as a GPipe pipeline: ``(out,
    aux)``, ``out`` [batch, seq, hidden] the last stage's on every stage.

    ``x``: this rank's batch (every stage's alike); ``layer_params``: its
    block of the stacked layers (a dict or a ``ShardedTree``);
    ``body_fn(x_mb, stage_params[, active])`` applies them to one
    microbatch and returns ``(y, aux)``; ``num_layers``: the whole stack's
    count (default: the block's times the stages). ``gate``: ``full``
    (the body alone), ``inner`` (the body given ``active``), ``none``
    (every tick runs, aux masked)."""
    num_stages = validate_pipeline_mesh(mesh)
    if num_stages == 1:
        return body_fn(x, layer_params)
    if gate not in ("full", "inner", "none"):
        raise ValueError(f"unknown gate mode {gate!r}; valid: full|inner|none")
    leaves = _leaves(layer_params)
    layer_count = num_layers if num_layers is not None else leaves[0].shape[0] * num_stages
    if layer_count % num_stages:
        raise ValueError(f"{layer_count} layers do not divide over {num_stages} stages")
    m = num_microbatches or 2 * num_stages
    dp = mesh.axis_size("data", "fsdp", "expert")
    if x.shape[0] % m:
        raise ValueError(f"per-replica batch {x.shape[0] * dp}//{dp} not divisible by "
                         f"{m} pipeline microbatches")
    need_grad = torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for t in leaves))
    plan = _Plan(body_fn, layer_params, mesh, m, gate, remat_ticks)
    return _GPipe.apply(plan, need_grad, x, *leaves)
