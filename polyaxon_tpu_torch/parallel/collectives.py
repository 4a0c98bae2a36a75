"""The collectives of the sharded step, over ``torch.distributed`` groups
(NCCL on the card, gloo on the CPU), with the autograd rules the step
needs:

- :func:`all_gather`: an fsdp shard to its full tensor; the backward
  reduce-scatters the full grad back to the shard, summed over the group
  (in the grad's own dtype, as XLA reduces a bf16 grad in bf16);
- :func:`differentiable_sum`: a sum over the group whose backward sums the
  grad over the group (a batch statistic every rank's loss reads);
- :func:`reshard`: a leaf stored cut one way over the group, read cut
  another (a user's partition rule on a compute axis); the backward moves
  the grad back, with no sum;
- Megatron's pair over the ``model`` group: :func:`copy_to_group`
  (identity forward, the grad summed backward: a column-parallel layer's
  replicated input) and :func:`reduce_from_group` (the sum forward,
  identity backward: a row-parallel layer's partial outputs, the JAX
  package's ``psum``);
- :func:`ring_shift`: tensors to the next rank of a ring and from the
  previous one (``batch_isend_irecv``), posted without waiting, so a ring
  computes while its next chunk travels; :class:`RingExchange` is the
  ring of a group as ring attention reads it;
- :func:`all_to_all`: equal blocks of dim 0 to each rank of the group,
  whose backward is the same exchange (its own inverse), for Ulysses;
- :func:`sum_over` and :func:`max_over`: in-place reductions outside
  autograd (counts, grads, metrics, a softmax's row max);
  :func:`gather_rows`: the group's tensors stacked, outside autograd (the
  MoE router's choices, which the capacity plan reads globally).
"""

from __future__ import annotations

from typing import Optional

import torch

_dist = torch.distributed
# the single-tensor forms under their newer names where torch has them
_ALL_GATHER = getattr(_dist, "all_gather_single", None) or _dist.all_gather_into_tensor
_REDUCE_SCATTER = (getattr(_dist, "reduce_scatter_single", None)
                   or _dist.reduce_scatter_tensor)


def _dense(t: torch.Tensor) -> torch.Tensor:
    """A dense copy of ``t`` (NCCL takes no strided view; a collective
    writes in place, so never the caller's tensor)."""
    return t.clone(memory_format=torch.contiguous_format)


def _gather(shard: torch.Tensor, dim: int, group, world: int) -> torch.Tensor:
    """The group's shards joined along ``dim`` (outside autograd), in the
    shard's own layout, so the model's products take the full leaf as they
    take an unsharded one."""
    x = shard.movedim(dim, 0).contiguous()
    out = x.new_empty((world * x.shape[0],) + tuple(x.shape[1:]))
    _ALL_GATHER(out, x, group=group)
    return out.movedim(0, dim).contiguous()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, dim, group, world):
        ctx.dim, ctx.group, ctx.world = dim, group, world
        return _gather(shard, dim, group, world)

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


def _move(x: torch.Tensor, gather: Optional[int], block: Optional[int], group, world: int,
          index: int) -> torch.Tensor:
    if gather is not None:
        x = _gather(x, gather, group, world)
    if block is not None:
        n = x.shape[block] // world
        x = x.narrow(block, index * n, n).contiguous()
    return x


class _Reshard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, stored, read, group, world, index):
        ctx.args = (read, stored, group, world, index)
        return _move(x, stored, read, group, world, index)

    @staticmethod
    def backward(ctx, grad):
        return (_move(grad, *ctx.args),) + (None,) * 5


def reshard(x: torch.Tensor, stored: Optional[int], read: Optional[int], group, world: int,
            index: int) -> torch.Tensor:
    """A tensor held cut at dim ``stored`` over the group (None: whole on
    every rank), as rank ``index``'s block at dim ``read`` (None: whole):
    gathered, then cut. The backward moves the grad the other way, from
    the read block to the stored one, with no sum: each rank's grad of its
    read is whole for that block (over ``model``, ``stage``)."""
    return _Reshard.apply(x, stored, read, group, world, index)


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = _dense(x)
        _dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        g = _dense(grad)
        _dist.all_reduce(g, group=ctx.group)
        return g, None


def differentiable_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the group's ranks. Every rank's loss reads the sum,
    so the grad of each rank's ``x`` is the sum of the ranks' grads of it;
    a bare ``all_reduce`` would drop the other ranks' terms."""
    return _Sum.apply(x, group)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = _dense(grad)
        _dist.all_reduce(g, group=ctx.group)
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is; its grad summed over the group. A replicated input
    that every rank's shard of a layer reads gets the sum of their grads."""
    return _CopyToGroup.apply(x, group)


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = _dense(x)
        _dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the group; the grad passes through. Every rank
    computes the same loss from the sum, so each rank's grad of the sum is
    already the grad of its own term."""
    return _ReduceFromGroup.apply(x, group)


class _Pending:
    """A posted exchange: :meth:`wait` returns what arrived."""

    def __init__(self, recv: list, works: list, shapes: list, sent: list):
        # the sent tensors stay referenced until their sends complete
        self._recv, self._works, self._shapes, self._sent = recv, works, shapes, sent

    def wait(self) -> list:
        for w in self._works:
            w.wait()
        it = iter(self._recv)
        return [tuple(next(it) for _ in range(n)) for n in self._shapes]


def ring_shift(chunks: list, group, send_to: int, recv_from: int) -> _Pending:
    """Post the move of ``chunks`` (tuples of tensors) one step along a
    ring: each tensor to rank ``send_to``, its counterpart from rank
    ``recv_from`` (global ranks of ``group``), in one
    ``batch_isend_irecv``; returns at once. Not differentiable: ring
    attention's backward is its own ring, which shifts the grads itself."""
    flat = [t.contiguous() for c in chunks for t in c]
    recv = [torch.empty_like(t) for t in flat]
    ops = []
    for t, r in zip(flat, recv):
        ops.append(_dist.P2POp(_dist.isend, t, send_to, group))
        ops.append(_dist.P2POp(_dist.irecv, r, recv_from, group))
    return _Pending(recv, _dist.batch_isend_irecv(ops), [len(c) for c in chunks], flat)


class RingExchange:
    """The ring of a torch group as ring attention reads it: this process
    holds one position (``index`` of ``size``) and its chunk of the
    sequence; :meth:`shift` posts the chunks' move one step along the
    ring (to ``send_to``, from ``recv_from``) and returns at once."""

    def __init__(self, group, size: int, index: int, *, send_to: int, recv_from: int):
        self.group, self.size, self.index = group, int(size), int(index)
        self.send_to, self.recv_from = int(send_to), int(recv_from)

    @property
    def ranks(self) -> tuple:
        return (self.index,)

    def local(self, x: torch.Tensor) -> list:
        return [x]

    def join(self, parts: list) -> torch.Tensor:
        return parts[0]

    def shift(self, chunks: list) -> _Pending:
        """``chunks``: one tuple of tensors per position held; what
        arrives is the previous position's."""
        return ring_shift(chunks, self.group, self.send_to, self.recv_from)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        src = x.contiguous()
        out = torch.empty_like(src)
        _dist.all_to_all_single(out, src, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        src = grad.contiguous()
        out = torch.empty_like(src)
        _dist.all_to_all_single(out, src, group=ctx.group)
        return out, None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Block i of ``x``'s dim 0 (equal blocks, one per rank) to rank i of
    the group; block j of the result came from rank j. Differentiable: the
    backward is the same exchange."""
    return _AllToAll.apply(x, group)


def sum_over(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` (dense: NCCL takes no strided view) summed over the group's
    ranks, in place, outside autograd."""
    _dist.all_reduce(t, group=group)
    return t


def max_over(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` (dense) reduced by max over the group's ranks, in place,
    outside autograd."""
    _dist.all_reduce(t, op=_dist.ReduceOp.MAX, group=group)
    return t


def gather_rows(t: torch.Tensor, group, world: int) -> torch.Tensor:
    """The group's ``t`` (equal shapes) stacked along a new leading dim in
    group-rank order, outside autograd."""
    src = t.reshape(-1).contiguous()
    out = src.new_empty(world * src.numel())
    _ALL_GATHER(out, src, group=group)
    return out.view((world,) + tuple(t.shape))
