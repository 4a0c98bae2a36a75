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

A view may also merge low-rank adapters into the leaves it reads
(``merge``: a tree of :class:`~..partition.lora.Adapter` at the targeted
leaves): the leaf is gathered first, then its adapter adds the delta of
the block the rank holds. A LoRA task's base reads through such a view, so
each layer gathers once and then adds its delta.
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
    with no cut reads as it is)."""

    def __init__(self, tree: dict, dims: dict,
                 gather: Optional[Callable[[torch.Tensor, int], torch.Tensor]],
                 merge: Optional[dict] = None):
        self._tree, self._dims, self._gather = tree, dims, gather
        self._merge = merge or {}
        self._read: dict = {}

    def __getitem__(self, key: str) -> Any:
        if key in self._read:
            return self._read[key]
        value, cuts, merge = self._tree[key], self._dims[key], self._merge.get(key)
        if isinstance(value, dict):
            out = ShardedTree(value, cuts, self._gather, merge)
        else:
            out = value
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
        return ShardedTree(self._tree, self._dims, self._gather, merge)

    def fresh(self) -> "ShardedTree":
        """A new view of the same shards: its reads gather again."""
        return ShardedTree(self._tree, self._dims, self._gather, self._merge)

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
                for (t, d), m in zip(split(self._tree, self._dims), merges)]

    def leaves(self) -> list:
        """The shards, in sorted-key order."""

        def walk(tree):
            if isinstance(tree, dict):
                return [leaf for k in sorted(tree) for leaf in walk(tree[k])]
            return [tree]

        return walk(self._tree)

    def with_leaves(self, leaves: list) -> "ShardedTree":
        """The same view over other shards (``leaves`` in :meth:`leaves`'
        order)."""
        it = iter(leaves)

        def build(tree):
            if isinstance(tree, dict):
                return {k: build(tree[k]) for k in sorted(tree)}
            return next(it)

        return ShardedTree(build(self._tree), self._dims, self._gather, self._merge)


def fresh(params: Any) -> Any:
    """A fresh view of a :class:`ShardedTree` (anything else as it is)."""
    return params.fresh() if isinstance(params, ShardedTree) else params
