"""The process mesh and the logical-axis sharding rules of the port —
counterpart of ``polyaxon_tpu/parallel/mesh.py``.

A mesh is the job's processes laid out over ``MESH_AXES``, one process per
GPU. Rank r sits at the coordinates JAX's device r holds in the row-major
reshape of its device list over the same axes (``data`` outermost), so
rank r gets the batch rows and the parameter blocks JAX's device r gets.
Unspecified capacity is absorbed into ``data``, with the JAX package's
errors, counted in processes where it counts devices.

Collectives run over ``torch.distributed`` groups, one per set of axes:
the ranks that share every other coordinate. The batch group (the batch
is sharded over ``data`` x ``fsdp`` x ``expert``), the token group (batch
x ``context``: a token's loss term lives on one context rank), the
``fsdp`` group of a leaf's shards, the ``model`` group of a tensor-parallel
layer's shards, the ``context`` group of a sequence's chunks (the ring's
and Ulysses' peers), the ``stage`` group of a pipeline's stages and the
``expert`` group that shares a layer's experts, and the token group less
the axes a leaf's grad is already summed over (fsdp's reduce-scatter, the
experts' gather or all-to-all). A group that spans the whole job is the
default group; one that spans a single rank is :data:`LOCAL`, and its
collectives are no-ops. Without a process group the mesh is one process
and has no groups.

A leaf of the params may be cut over several axes at once, one dim each
(``stage``: the stacked layer dim; ``expert``: the experts; ``fsdp``: the
embed dim; ``model``: heads, mlp columns, vocab rows): its *cuts* are
``(axis, dim)`` pairs, and :meth:`Mesh.shard` / :meth:`Mesh.gather_full`
take this rank's block of a full leaf and join the blocks back.

With ``num_slices`` N > 1 the job spans N slices (hosts joined by the
slower network): rank r sits in slice ``r // (W / N)``, the JAX package's
contiguous virtual slices, and since ``data · fsdp`` must divide by N the
row-major rank order puts every ``stage``/``expert``/``context``/``model``
group inside one slice — only data and fsdp coordinates cross slices, as
on the JAX mesh's slice-major device array.

The logical rules are the JAX package's, over a tuple ``PartitionSpec`` of
the same entries.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional, Sequence, Union

import torch

from . import collectives

# Canonical mesh axis order, outermost first.
MESH_AXES: tuple[str, ...] = ("data", "fsdp", "stage", "expert", "context", "model")
#: the axes the batch dim is sharded over (the rule for "batch")
BATCH_AXES: tuple[str, ...] = ("data", "fsdp", "expert")
#: the axes a token's place is sharded over: its row, then its chunk of
#: the sequence (the loss's counts and the step's metrics sum over them)
TOKEN_AXES: tuple[str, ...] = BATCH_AXES + ("context",)
#: the axes a leaf's shards are gathered over when the model reads it (or,
#: for the experts, the tokens are sent to them), whose backward sums the
#: grad over that axis
GATHERED_AXES: tuple[str, ...] = ("fsdp", "expert")
#: the group of a set of axes that spans one rank: collectives over it are
#: no-ops
LOCAL = "local"


def grad_sum_axes(cut: Sequence[str], token_axes: Sequence[str] = TOKEN_AXES) -> tuple:
    """The axes a leaf's grad is summed over after the backward: the token
    axes (``BATCH_AXES`` for a task that replicates its compute over
    ``context``), less those its gathers summed over already (``cut``: the
    axes the leaf is cut over)."""
    return tuple(a for a in token_axes if not (a in GATHERED_AXES and a in cut))


_GROUP_AXES = tuple(dict.fromkeys(
    (("fsdp",), ("data",), BATCH_AXES, TOKEN_AXES, ("model",), ("context",), ("stage",),
     ("expert",)) + tuple(grad_sum_axes(cut, token) for token in (TOKEN_AXES, BATCH_AXES)
                          for cut in (("fsdp",), ("expert",), ("fsdp", "expert")))))


def normalize_axis_sizes(parallelism: Union[Mapping[str, int], Any, None]) -> dict[str, int]:
    """Accept a V1Parallelism, a dict, or None and return {axis: size} in
    canonical order with every axis present (size 1 when unspecified)."""
    if parallelism is None:
        sizes: Mapping[str, int] = {}
    elif hasattr(parallelism, "axis_sizes"):
        sizes = parallelism.axis_sizes()
    else:
        sizes = dict(parallelism)
    unknown = set(sizes) - set(MESH_AXES)
    if unknown:
        raise ValueError(f"Unknown mesh axes {sorted(unknown)}; valid: {MESH_AXES}")
    return {ax: int(sizes.get(ax, 1)) for ax in MESH_AXES}


def mesh_sizes(parallelism: Union[Mapping[str, int], Any, None], n: int) -> dict[str, int]:
    """``build_mesh``'s size logic over ``n`` processes: the declared axes,
    with unspecified capacity absorbed into ``data``."""
    sizes = normalize_axis_sizes(parallelism)
    declared = math.prod(sizes.values())
    if declared > n:
        raise ValueError(f"Mesh needs {declared} devices but only {n} available")
    if n % declared != 0:
        raise ValueError(f"{n} devices not divisible by declared mesh size {declared}")
    if n // declared > 1:
        if sizes["data"] != 1 and declared != n:
            raise ValueError(f"Mesh axes {sizes} (={declared}) do not cover {n} devices")
        if sizes["data"] == 1:
            sizes["data"] = n // declared
    return sizes


@dataclass
class Mesh:
    """The processes of a job over ``MESH_AXES``. ``declared`` holds the
    axes the job's ``parallelism`` named (a declared ``fsdp`` axis shards
    params under a process group even at size 1)."""

    sizes: dict
    rank: int = 0
    distributed: bool = False
    declared: frozenset = frozenset()
    _groups: dict = field(default_factory=dict, repr=False)

    @property
    def shape(self) -> dict:
        return dict(self.sizes)

    @property
    def size(self) -> int:
        return math.prod(self.sizes.values())

    def coords(self, rank: Optional[int] = None) -> dict:
        """{axis: coordinate} of ``rank`` (this process by default)."""
        r = self.rank if rank is None else int(rank)
        out = {}
        for ax in reversed(MESH_AXES):
            r, out[ax] = divmod(r, self.sizes[ax])
        return {ax: out[ax] for ax in MESH_AXES}

    def index(self, axes: Sequence[str], rank: Optional[int] = None) -> int:
        """Row-major index of ``rank`` over ``axes`` (its block of an array
        dim sharded over them)."""
        c = self.coords(rank)
        idx = 0
        for ax in axes:
            idx = idx * self.sizes[ax] + c[ax]
        return idx

    # -- fsdp ---------------------------------------------------------------------

    @property
    def sharded(self) -> bool:
        """Params, grads and optimizer state are sharded over ``fsdp``:
        under a process group whenever the axis was declared (at size 1
        too), else never."""
        return self.distributed and ("fsdp" in self.declared or self.sizes["fsdp"] > 1)

    # -- groups -------------------------------------------------------------------

    def rank_of(self, coords: Mapping[str, int]) -> int:
        """The rank at ``coords`` (missing axes at 0): :meth:`coords`'
        inverse."""
        r = 0
        for ax in MESH_AXES:
            r = r * self.sizes[ax] + int(coords.get(ax, 0))
        return r

    def _make_groups(self) -> None:
        """One torch group per (axes, fixed coordinates of the other axes);
        every rank creates every group, in the same order."""
        dist = torch.distributed
        for axes in _GROUP_AXES:
            span = math.prod(self.sizes[a] for a in axes)
            if span == self.size:
                self._groups[axes] = None  # the default group
                continue
            if span == 1:
                self._groups[axes] = LOCAL
                continue
            buckets: dict = {}
            for r in range(self.size):
                c = self.coords(r)
                key = tuple(c[a] for a in MESH_AXES if a not in axes)
                buckets.setdefault(key, []).append(r)
            mine = None
            for key in sorted(buckets):
                g = dist.new_group(ranks=buckets[key])
                if self.rank in buckets[key]:
                    mine = g
            self._groups[axes] = mine

    def group(self, *axes: str):
        """The torch group of this rank over ``axes`` (None: the default)."""
        return self._groups[tuple(axes)]

    def axis_size(self, *axes: str) -> int:
        return math.prod(self.sizes[a] for a in axes)

    # -- collectives ----------------------------------------------------------------

    def gather(self, shard: torch.Tensor, dim: int, axis: str = "fsdp") -> torch.Tensor:
        """The full tensor of a leaf cut over ``axis`` (fsdp, or the
        experts); its backward reduce-scatters the grad back to the shard
        (summed over the axis)."""
        if self.group(axis) is LOCAL:
            return shard
        return collectives.all_gather(shard, dim, self.group(axis), self.sizes[axis])

    def gather_full(self, shard: torch.Tensor, cuts: Sequence) -> torch.Tensor:
        """The whole leaf of this rank's block, outside autograd
        (checkpoint saves): gathered over each ``(axis, dim)`` of ``cuts``;
        identity for a replicated leaf."""
        with torch.no_grad():
            for axis, dim in cuts:
                if self.group(axis) is not LOCAL:
                    shard = collectives.all_gather(shard, dim, self.group(axis),
                                                   self.sizes[axis])
        return shard

    def reshard(self, t: torch.Tensor, axis: str, stored: Optional[int],
                read: Optional[int]) -> torch.Tensor:
        """A leaf stored cut over ``axis`` at dim ``stored`` (None: whole),
        read as the block at dim ``read`` (None: whole). Over ``model`` and
        ``stage`` every rank's grad of what it read is whole for that block
        (a replicated read: the same on every rank), so the backward moves
        it back without a sum (:func:`~.collectives.reshard`). Over
        ``expert``, a batch axis, each rank's grad is its tokens' part: the
        backward is the read's adjoint (a gather's reduce-scatter, a
        block's zero-padding), and the step's sum over the batch axes
        completes a leaf stored whole."""
        if axis == "expert":
            if stored is not None:
                t = self.gather(t, stored, axis)
            return t if read is None else self.block(t, read, axis)
        return collectives.reshard(t, stored, read, self.group(axis), self.sizes[axis],
                                   self.coords()[axis])

    def shard(self, full: torch.Tensor, cuts: Sequence) -> torch.Tensor:
        """This rank's block of ``full`` along each ``(axis, dim)`` of
        ``cuts`` (a copy when any cuts)."""
        for axis, dim in cuts:
            full = self.block(full, dim, axis)
        return full.clone() if cuts else full

    def block(self, full: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
        """This rank's block of ``full`` along ``dim`` under ``axis`` (a
        view)."""
        n = full.shape[dim] // self.sizes[axis]
        return full.narrow(dim, self.coords()[axis] * n, n)

    def batch_count(self, count: torch.Tensor,
                    axes: Sequence[str] = TOKEN_AXES) -> torch.Tensor:
        """A count over the whole batch (every rank's rows and sequence
        chunks; ``axes``: the batch's alone where the sequence is not cut):
        the denominator of a token mean (not differentiated)."""
        return self.sum_(count.detach().float(), *axes)

    def batch_mean(self, local_sum: torch.Tensor, local_count: int) -> torch.Tensor:
        """The mean over the whole batch of a quantity whose sum over this
        rank's rows is ``local_sum``; differentiable (its backward
        all-reduces the grad), as XLA's psum of a batch mean."""
        group = self.group(*BATCH_AXES)
        total = local_sum if group is LOCAL else collectives.differentiable_sum(local_sum, group)
        return total / (local_count * self.axis_size(*BATCH_AXES))

    def sum_(self, t: torch.Tensor, *axes: str) -> torch.Tensor:
        """In-place sum of ``t`` over the ranks of ``axes``."""
        group = self.group(*axes)
        return t if group is LOCAL else collectives.sum_over(t, group)

    # -- tensor and context parallelism ---------------------------------------------

    @property
    def tp(self) -> bool:
        """Layers are split over the ``model`` axis."""
        return self.distributed and self.sizes["model"] > 1

    @property
    def cp(self) -> int:
        """Chunks the sequence is cut into (the ``context`` axis; 1 off a
        process group)."""
        return self.sizes["context"] if self.distributed else 1

    @property
    def seq_index(self) -> int:
        """This rank's chunk of the sequence."""
        return self.coords()["context"] if self.distributed else 0

    def to_model(self, x: torch.Tensor) -> torch.Tensor:
        """A column-parallel layer's input: identity forward, the grad
        summed over model backward (Megatron's f)."""
        return collectives.copy_to_group(x, self.group("model")) if self.tp else x

    def from_model(self, x: torch.Tensor) -> torch.Tensor:
        """A row-parallel layer's partial output summed over model:
        identity backward (Megatron's g, the JAX ``psum``)."""
        return collectives.reduce_from_group(x, self.group("model")) if self.tp else x

    def sum_over_context(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the context ranks; the grad summed too (every
        context rank's loss reads the sum)."""
        return collectives.differentiable_sum(x, self.group("context"))

    def max_over_model_(self, t: torch.Tensor) -> torch.Tensor:
        """In-place max of ``t`` over model, outside autograd."""
        if self.tp:
            collectives.max_over(t, self.group("model"))
        return t

    # -- pipeline and expert parallelism --------------------------------------------

    @property
    def pp(self) -> int:
        """Pipeline stages (the ``stage`` axis; 1 off a process group)."""
        return self.sizes["stage"] if self.distributed else 1

    @property
    def ep(self) -> int:
        """Ranks that share a layer's experts (the ``expert`` axis; 1 off a
        process group)."""
        return self.sizes["expert"] if self.distributed else 1

    @property
    def stage_index(self) -> int:
        return self.coords()["stage"] if self.distributed else 0

    def stage_rank(self, stage: int) -> int:
        """The global rank of ``stage`` in this rank's stage group."""
        return self.rank_of({**self.coords(), "stage": int(stage)})

    def ring(self) -> "collectives.RingExchange":
        """The ring over this rank's ``context`` group: chunks go to the
        next context coordinate and come from the previous one."""
        c = self.coords()
        cp, i = self.sizes["context"], c["context"]
        peer = lambda j: self.rank_of({**c, "context": j % cp})  # noqa: E731
        return collectives.RingExchange(self.group("context"), cp, i,
                                        send_to=peer(i + 1), recv_from=peer(i - 1))

    def agree(self, value: Optional[int], device) -> Optional[int]:
        """Rank 0's ``value`` (an int or None) on every rank."""
        if not self.distributed:
            return value
        t = torch.tensor([-1 if value is None else int(value)], dtype=torch.int64,
                         device=device)
        torch.distributed.broadcast(t, src=0)
        got = int(t.item())
        return None if got < 0 else got

    def barrier(self) -> None:
        if self.distributed:
            torch.distributed.barrier()


def device_slice_ids(world_size: int, num_slices: int) -> list[int]:
    """Slice id per rank: contiguous equal groups in rank order (the JAX
    package's virtual slices)."""
    if world_size % num_slices:
        raise ValueError(
            f"{world_size} devices cannot split into {num_slices} equal virtual "
            f"slices")
    per = world_size // num_slices
    return [r // per for r in range(world_size)]


def check_multislice(sizes: Mapping[str, int], world_size: int, num_slices: int) -> None:
    """Raise, with the JAX package's errors, unless the slice dimension can
    live on the data/fsdp axes (so no other axis crosses a slice)."""
    if world_size % num_slices:
        raise ValueError(
            f"{world_size} devices not divisible by num_slices={num_slices}")
    dcn = sizes["data"] * sizes["fsdp"]
    if dcn % num_slices:
        raise ValueError(
            f"multislice mesh: data*fsdp = {sizes['data']}*{sizes['fsdp']} "
            f"= {dcn} must be divisible by num_slices={num_slices} — the "
            f"slice dimension has to live on the DCN-capable data/fsdp "
            f"axes; model/context/stage/expert collectives must stay on "
            f"intra-slice ICI")


def build_mesh(parallelism: Union[Mapping[str, int], Any, None] = None,
               world_size: Optional[int] = None, *, rank: Optional[int] = None,
               num_slices: int = 1) -> Mesh:
    """The job's mesh over its processes (the process group's, else one).
    Makes the group's per-axis subgroups, so every rank calls it alike.
    ``num_slices`` > 1 checks that the slices split the world and the
    data x fsdp product; the rank order is the same at any slice count."""
    num_slices = int(num_slices or 1)
    dist = torch.distributed
    distributed = dist.is_available() and dist.is_initialized()
    if world_size is None:
        world_size = dist.get_world_size() if distributed else 1
    if rank is None:
        rank = dist.get_rank() if distributed else 0
    sizes = mesh_sizes(parallelism, int(world_size))
    if num_slices > 1:
        check_multislice(sizes, int(world_size), num_slices)
    declared = frozenset() if parallelism is None else frozenset(
        parallelism.axis_sizes() if hasattr(parallelism, "axis_sizes") else parallelism)
    mesh = Mesh(sizes=sizes, rank=int(rank), distributed=distributed, declared=declared)
    if distributed:
        mesh._make_groups()
    return mesh


def mesh_axis_size(mesh: Mesh, *axes: str) -> int:
    return mesh.axis_size(*axes)


# ---------------------------------------------------------------------------
# Logical axis rules
# ---------------------------------------------------------------------------

# Logical name -> mesh axes, the JAX package's table: model code names each
# array's dims logically and the rules decide which mesh axes shard them.
DEFAULT_RULES: tuple[tuple[str, Any], ...] = (
    ("batch", ("data", "fsdp", "expert")),
    ("layers", None),           # the stacked layer dim is never sharded
    ("seq", "context"),
    ("embed", "fsdp"),          # params: fsdp-shard the embed dim (zero-3 style)
    ("embed_act", None),        # activations keep embed replicated...
    ("embed_tp", "model"),      # ...except where TP shards them
    ("heads", "model"),
    ("kv_heads", "model"),
    ("head_dim", None),
    ("mlp", "model"),
    ("vocab", "model"),
    ("expert", "expert"),
    ("stage", "stage"),
    ("conv_kernel", None),
    ("channels", None),
    ("classes", None),
)


class PartitionSpec(tuple):
    """Per-dim mesh axes of an array (None: replicated), as JAX's."""

    def __new__(cls, *parts: Any) -> "PartitionSpec":
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


@dataclass(frozen=True)
class ShardingRules:
    """Mapping from logical axis names to mesh axis names (or None)."""

    rules: tuple[tuple[str, Any], ...] = DEFAULT_RULES

    def mesh_axes(self, logical: Optional[str]) -> Any:
        if logical is None:
            return None
        for name, axes in self.rules:
            if name == logical:
                return axes
        raise KeyError(f"No sharding rule for logical axis {logical!r}")

    def spec(self, logical_axes: Sequence[Optional[str]]) -> PartitionSpec:
        return PartitionSpec(*(self.mesh_axes(ax) for ax in logical_axes))

    def override(self, **kwargs: Any) -> "ShardingRules":
        """New rules with some logical names remapped, e.g.
        ``rules.override(embed=None)`` to turn fsdp param sharding off."""
        out = [(n, kwargs[n]) if n in kwargs else (n, a) for n, a in self.rules]
        for k in kwargs:
            if k not in dict(self.rules):
                out.append((k, kwargs[k]))
        return ShardingRules(rules=tuple(out))


def divisible_dim(spec: Sequence[Any], shape: Sequence[int], axis: str, n: int) -> Optional[int]:
    """The dim of ``spec`` sharded over ``axis`` (None: none is); raises as
    JAX's NamedSharding does when the dim does not divide by ``n``."""
    d = sharded_dim(spec, axis)
    if d is not None and shape[d] % n:
        raise ValueError(
            f"the sharding {tuple(spec)} implies that the global size of its dimension "
            f"{d} should be divisible by {n}, but it is equal to "
            f"{shape[d]} (full shape: {tuple(shape)})")
    return d


def sharded_dim(spec: Sequence[Any], axis: str = "fsdp") -> Optional[int]:
    """The dim of a spec sharded over ``axis`` (None: none is)."""
    for d, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else (entry,)
        if axis in names:
            return d
    return None
