"""fsdp (ZeRO-3) params of the port: each rank holds its block of every
``embed``-sharded leaf, and the model reads the full leaf only where it
uses it. Experts cut over the ``expert`` axis read the same way where the
dispatch needs every expert (capacity and dense).

:class:`ShardedTree` is the param tree the model sees under fsdp (or with
gathered experts). Reading a leaf gathers it over each of its gathered
axes (once per view); a subtree is a view of its own. The
layer stack is never gathered whole: ``run_trunk`` calls :meth:`unstack`
for one view per layer, whose leaves gather when that layer runs, and a
remat policy rereads a :meth:`fresh` view in its recompute, so the
backward gathers the layer again instead of keeping it. Each gather's
backward reduce-scatters the grad to the shard.

A view may also reshard a leaf that a user's partition rule stores cut
otherwise than the layer bodies read it over a compute axis (``reshard``:
a tree of each leaf's ``(axis, stored dim, read dim)`` moves and the
mesh's ``reshard``): the stored block is gathered on the rule's cut and
cut as the built-in spec cuts it, before the fsdp gather. A stacked leaf
is resharded whole (the stage cut is its layer dim), once per view, and
the per-layer views of :meth:`unstack` and the leaves of :meth:`leaves`
are of the resharded leaves.

A view may also merge low-rank adapters into the leaves it reads
(``merge``: a tree of :class:`~..partition.lora.Adapter` at the targeted
leaves): the leaf is resharded and gathered first, then its adapter adds
the delta of the block the rank reads. A LoRA task's base reads through
such a view, so each layer gathers once and then adds its delta.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from .mesh import divisible_dim


def leaf_dims(specs: Any, params: dict, size: int, axis: str = "fsdp") -> dict:
    """The tree of ``axis``-sharded dims (None: replicated) of ``params``
    under the tree of PartitionSpecs ``specs``. A sharded dim that does
    not divide by the axis' size raises, as JAX's NamedSharding does."""
    if isinstance(params, dict):
        return {k: leaf_dims(specs[k], v, size, axis) for k, v in params.items()}
    return divisible_dim(specs, params.shape, axis, size)


class ShardedTree:
    """A read-only view of a tree of shards whose leaves read as full
    tensors: ``dims`` holds each leaf's ``(axis, dim)`` cuts, and
    ``gather(shard, dim, axis)`` joins a cut when the leaf is read (a leaf
    with no cut reads as it is); ``reshard``, when given, is ``(moves,
    move)``: each leaf's moves and ``move(t, axis, stored, read)``."""

    def __init__(self, tree: dict, dims: dict,
                 gather: Optional[Callable[[torch.Tensor, int], torch.Tensor]],
                 merge: Optional[dict] = None, reshard: Optional[tuple] = None):
        self._tree, self._dims, self._gather = tree, dims, gather
        self._merge = merge or {}
        self._reshard = reshard
        self._read: dict = {}
        self._moved: dict = {}

    def _sub(self, key: str, value: dict) -> "ShardedTree":
        reshard = None if self._reshard is None else (self._reshard[0][key], self._reshard[1])
        return ShardedTree(value, self._dims[key], self._gather, self._merge.get(key), reshard)

    def _stored(self, key: str) -> torch.Tensor:
        """Leaf ``key`` resharded to the block the layer bodies read (once
        per view), still cut over the gathered axes."""
        if key not in self._moved:
            out = self._tree[key]
            if self._reshard is not None:
                moves, move = self._reshard
                for axis, stored, read in moves[key]:
                    out = move(out, axis, stored, read)
            self._moved[key] = out
        return self._moved[key]

    def __getitem__(self, key: str) -> Any:
        if key in self._read:
            return self._read[key]
        value, cuts, merge = self._tree[key], self._dims[key], self._merge.get(key)
        if isinstance(value, dict):
            out = self._sub(key, value)
        else:
            out = self._stored(key)
            for axis, dim in cuts:
                out = self._gather(out, dim, axis)
            if merge is not None:
                out = merge.apply(out)
        self._read[key] = out
        return out

    def get(self, key: str, default: Optional[Any] = None) -> Any:
        return self[key] if key in self._tree else default

    def __contains__(self, key: object) -> bool:
        return key in self._tree

    def with_merge(self, merge: dict) -> "ShardedTree":
        """A view of the same shards that merges ``merge``'s adapters."""
        return ShardedTree(self._tree, self._dims, self._gather, merge, self._reshard)

    def fresh(self) -> "ShardedTree":
        """A new view of the same shards: its reads reshard and gather
        again."""
        return ShardedTree(self._tree, self._dims, self._gather, self._merge, self._reshard)

    def _resharded(self) -> dict:
        """The tree of the resharded leaves (the tree itself without
        moves)."""
        if self._reshard is None:
            return self._tree
        return {k: (self[k]._resharded() if isinstance(v, dict) else self._stored(k))
                for k, v in self._tree.items()}

    def unstack(self, n: int) -> list:
        """Views of the ``n`` layers of a stacked ``[L, ...]`` tree: one
        unbind per leaf, each layer's dims one lower."""

        def split(tree, dims):
            if isinstance(tree, dict):
                parts = {k: split(tree[k], dims[k]) for k in tree}
                return [({k: parts[k][i][0] for k in tree}, {k: parts[k][i][1] for k in tree})
                        for i in range(n)]
            cuts = tuple((axis, d - 1) for axis, d in dims)
            return [(t, cuts) for t in torch.unbind(tree, 0)]

        def split_merge(merge):
            if isinstance(merge, dict):
                parts = {k: split_merge(v) for k, v in merge.items()}
                return [{k: parts[k][i] for k in merge} for i in range(n)]
            return merge.unstack(n)

        merges = split_merge(self._merge) if self._merge else [None] * n
        return [ShardedTree(t, d, self._gather, m)
                for (t, d), m in zip(split(self._resharded(), self._dims), merges)]

    def leaves(self) -> list:
        """The shards as the layer bodies read them (resharded, still cut
        over the gathered axes), in sorted-key order."""

        def walk(tree):
            if isinstance(tree, dict):
                return [leaf for k in sorted(tree) for leaf in walk(tree[k])]
            return [tree]

        return walk(self._resharded())

    def with_leaves(self, leaves: list) -> "ShardedTree":
        """The same view over other shards (``leaves`` in :meth:`leaves`'
        order: resharded already)."""
        it = iter(leaves)

        def build(tree):
            if isinstance(tree, dict):
                return {k: build(tree[k]) for k in sorted(tree)}
            return next(it)

        return ShardedTree(build(self._tree), self._dims, self._gather, self._merge)


def fresh(params: Any) -> Any:
    """A fresh view of a :class:`ShardedTree` (anything else as it is)."""
    return params.fresh() if isinstance(params, ShardedTree) else params
