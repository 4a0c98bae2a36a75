"""The collectives of the sharded step, over ``torch.distributed`` groups
(NCCL on the card, gloo on the CPU), with the autograd rules the step
needs:

- :func:`all_gather`: an fsdp shard to its full tensor; the backward
  reduce-scatters the full grad back to the shard, summed over the group
  (in the grad's own dtype, as XLA reduces a bf16 grad in bf16);
- :func:`differentiable_sum`: a sum over the group whose backward sums the
  grad over the group (a batch statistic every rank's loss reads);
- :func:`sum_over`: an in-place sum outside autograd (counts, grads,
  metrics).
"""

from __future__ import annotations

import torch

_dist = torch.distributed
# the single-tensor forms under their newer names where torch has them
_ALL_GATHER = getattr(_dist, "all_gather_single", None) or _dist.all_gather_into_tensor
_REDUCE_SCATTER = (getattr(_dist, "reduce_scatter_single", None)
                   or _dist.reduce_scatter_tensor)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, dim, group, world):
        ctx.dim, ctx.group, ctx.world = dim, group, world
        x = shard.movedim(dim, 0).contiguous()
        out = x.new_empty((world * x.shape[0],) + tuple(x.shape[1:]))
        _ALL_GATHER(out, x, group=group)
        # in the shard's own layout, so the model's products take the full
        # leaf as they take an unsharded one
        return out.movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, grad):
        g = grad.movedim(ctx.dim, 0).contiguous()
        out = g.new_empty((g.shape[0] // ctx.world,) + tuple(g.shape[1:]))
        _REDUCE_SCATTER(out, g, group=ctx.group)
        return out.movedim(0, ctx.dim).contiguous(), None, None, None


def all_gather(shard: torch.Tensor, dim: int, group, world: int) -> torch.Tensor:
    """The group's shards of a tensor joined along ``dim`` in group-rank
    order; differentiable (the backward is a reduce-scatter)."""
    return _AllGather.apply(shard, dim, group, world)


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        _dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        _dist.all_reduce(g, group=ctx.group)
        return g, None


def differentiable_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the group's ranks. Every rank's loss reads the sum,
    so the grad of each rank's ``x`` is the sum of the ranks' grads of it;
    a bare ``all_reduce`` would drop the other ranks' terms."""
    return _Sum.apply(x, group)


def sum_over(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` (dense: NCCL takes no strided view) summed over the group's
    ranks, in place, outside autograd."""
    _dist.all_reduce(t, group=group)
    return t
