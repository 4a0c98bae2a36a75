"""The port's state, block by block: an init law that one rank evaluates
for its own block of each leaf, and where each rank's block lies.

The JAX package initializes its params straight into their shards (a
jitted init with ``out_shardings``): no device ever holds a leaf whole,
and the values do not depend on the mesh. The port keeps the same
contract with one ``torch.Generator`` per *slice* of a leaf:

- a slice is one index of the leaf's leading slice dims (``Law.lead``):
  one layer of a stacked ``[L, ...]`` leaf, one (layer, expert) of an
  expert stack ``[L, E, ...]``; a leaf without such dims is one slice;
- a slice's generator is seeded from (seed, the leaf's key, the slice's
  leading indices) by a stable hash (``slice_seed``: blake2b, not Python's
  ``hash``), so any process can draw any slice on its own;
- :func:`leaf_block` builds the block of one leaf that a rank holds from
  explicit axis sizes and coordinates, not a live process group: it draws
  only the slices whose leading indices meet the block (under ``stage`` or
  ``expert`` the other ranks' slices are skipped) and keeps each slice's
  part (under ``fsdp`` or ``model`` each slice is drawn whole and cut).

A rank's peak while it builds a leaf is therefore its block plus one
slice, and its block equals the same block of the whole-tree init bit for
bit on the same device type (the whole tree is the block with no cuts).

A block is described by a leaf's *cuts*: ``(axis, dim)`` pairs, applied in
order as :meth:`~.mesh.Mesh.shard` applies them (a dim cut over two axes
is cut by the first, then its block by the second). :class:`Placement`
holds the cuts of every leaf of a tree (by ``/``-joined path), the mesh's
axis sizes and a rank's coordinates: the trainer's layout, which import,
checkpoint save and restore read too.
"""

from __future__ import annotations

import hashlib
import itertools
import math
from dataclasses import dataclass, field, replace
from typing import Any, Mapping, Optional, Sequence

import torch

#: the logical axes of a leaf's leading dims that index its slices
SLICE_AXES = ("layers", "expert")

_TRUNC_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
_TRUNC_HI = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))


@dataclass(frozen=True)
class Law:
    """How one leaf is initialized: its ``shape``, the distribution
    (``kind``: ``trunc_normal``, a standard normal truncated at ±2, or
    ``normal``, each times ``scale``; ``zeros``; ``ones``), how many
    leading dims index its slices (``lead``), its dtype, and ``key``: the
    name its slice seeds hash (its path in the tree the law was made
    for)."""

    shape: tuple
    kind: str
    scale: float = 1.0
    lead: int = 0
    dtype: torch.dtype = torch.float32
    key: str = ""


def lead_of(logical_axes: Sequence[Optional[str]]) -> int:
    """How many leading logical axes are slice axes (the layers, then the
    experts of an expert stack)."""
    n = 0
    for ax in logical_axes:
        if ax not in SLICE_AXES:
            break
        n += 1
    return n


def keyed(laws: Any, prefix: str = "") -> Any:
    """The tree of laws with each law's ``key`` set to ``prefix`` + its
    ``/``-joined path."""
    if isinstance(laws, dict):
        return {k: keyed(v, f"{prefix}{k}/") for k, v in laws.items()}
    return replace(laws, key=prefix[:-1])


def slice_seed(seed: int, key: str, index: Sequence[int]) -> int:
    """The seed of one slice's generator: a stable 63-bit hash of (seed,
    the leaf's key, the slice's leading indices)."""
    text = f"{int(seed)}|{key}|{','.join(str(int(i)) for i in index)}"
    digest = hashlib.blake2b(text.encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def trunc_normal_(u: torch.Tensor) -> torch.Tensor:
    """A uniform [0, 1) draw turned in place into a standard normal
    truncated to [-2, 2] (the inverse CDF between the bounds' CDF
    values)."""
    u.mul_(_TRUNC_HI - _TRUNC_LO).add_(_TRUNC_LO).mul_(2.0).sub_(1.0)
    return u.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)


def draw_slice(law: Law, index: Sequence[int], seed: int, device: Any) -> torch.Tensor:
    """Slice ``index`` (its leading indices) of a random leaf, whole, in the
    law's dtype: one tensor of the slice's size (the draw is transformed in
    place)."""
    shape = tuple(law.shape[law.lead:])
    gen = torch.Generator(device=device)
    gen.manual_seed(slice_seed(seed, law.key, index))
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if law.kind == "trunc_normal":
        trunc_normal_(t.uniform_(generator=gen))
    else:
        t.normal_(generator=gen)
    t.mul_(law.scale)
    return t.to(law.dtype)


def block_bounds(shape: Sequence[int], cuts: Sequence, sizes: Mapping[str, int],
                 coords: Mapping[str, int]) -> tuple[list, list]:
    """(start, size) per dim of the block at ``coords`` of a leaf of
    ``shape`` cut by ``cuts`` over a mesh of ``sizes``."""
    start, size = [0] * len(shape), list(shape)
    for axis, dim in cuts:
        n = size[dim] // sizes[axis]
        start[dim] += int(coords[axis]) * n
        size[dim] = n
    return start, size


def leaf_block(law: Law, cuts: Sequence, sizes: Mapping[str, int],
               coords: Mapping[str, int], seed: int, device: Any) -> torch.Tensor:
    """The block of one leaf (``law``: its shape, distribution and key) at
    ``coords`` of a mesh of axis ``sizes``, cut by ``cuts``: only the
    slices the block meets are drawn, each whole and then cut. A pure
    function of its arguments: any process can build any rank's block."""
    device = torch.device(device)
    start, size = block_bounds(law.shape, cuts, sizes, coords)
    if device.type == "meta" or law.kind in ("zeros", "ones"):
        fill = torch.zeros if law.kind != "ones" else torch.ones
        make = torch.empty if device.type == "meta" else fill
        return make(size, dtype=law.dtype, device=device)
    lead = law.lead
    trailing = [(d, start[d], size[d]) for d in range(lead, len(size))
                if size[d] != law.shape[d]]

    def cut(t: torch.Tensor) -> torch.Tensor:
        for d, s, n in trailing:
            t = t.narrow(d - lead, s, n)
        return t

    if lead == 0:
        t = draw_slice(law, (), seed, device)
        return cut(t).clone() if trailing else t
    out = torch.empty(size, dtype=law.dtype, device=device)
    for index in itertools.product(*(range(start[d], start[d] + size[d])
                                     for d in range(lead))):
        local = tuple(i - start[d] for d, i in enumerate(index))
        out[local].copy_(cut(draw_slice(law, index, seed, device)))
    return out


@dataclass(frozen=True)
class Placement:
    """Where one rank's blocks of a tree lie: each leaf's cuts by its
    ``/``-joined path (a leaf not named is whole), the mesh's axis sizes and
    the rank's coordinates."""

    cuts: dict = field(default_factory=dict)
    sizes: dict = field(default_factory=dict)
    coords: dict = field(default_factory=dict)

    def leaf_cuts(self, path: str) -> tuple:
        return tuple(self.cuts.get(path, ()))

    def bounds(self, path: str, shape: Sequence[int]) -> tuple[list, list]:
        """(start, size) per dim of this rank's block of leaf ``path``."""
        return block_bounds(shape, self.leaf_cuts(path), self.sizes, self.coords)

    def index(self, path: str, shape: Sequence[int]) -> tuple:
        """This rank's block of leaf ``path`` as a tuple of slices."""
        start, size = self.bounds(path, shape)
        return tuple(slice(s, s + n) for s, n in zip(start, size))

    def writes(self, path: str) -> bool:
        """Whether this rank is the first holder of its block of ``path``
        (every coordinate off the leaf's cut axes is 0): the one rank that
        writes the block to a checkpoint."""
        cut = {a for a, _ in self.leaf_cuts(path)}
        return all(int(c) == 0 for a, c in self.coords.items() if a not in cut)

    def under(self, prefix: str) -> "Placement":
        """The placement of the subtree at ``prefix`` (its paths without
        the prefix)."""
        head = prefix.rstrip("/") + "/"
        return replace(self, cuts={p[len(head):]: c for p, c in self.cuts.items()
                                   if p.startswith(head)})

    def prefixed(self, prefix: str) -> "Placement":
        """The same cuts under ``prefix`` (a subtree placed in a larger
        tree)."""
        head = prefix.rstrip("/") + "/"
        return replace(self, cuts={head + p: c for p, c in self.cuts.items()})


def init_tree(laws: Any, seed: int, device: Any,
              placement: Optional[Placement] = None, prefix: str = "") -> Any:
    """The tree of laws evaluated: each leaf's block under ``placement``
    (the whole leaf without one), drawn with its law's key. ``prefix``:
    the path of ``laws`` in the tree the placement names."""
    if laws is None:
        return None
    if isinstance(laws, dict):
        return {k: init_tree(v, seed, device, placement, f"{prefix}{k}/")
                for k, v in laws.items()}
    if placement is None:
        return leaf_block(laws, (), {}, {}, seed, device)
    return leaf_block(laws, placement.leaf_cuts(prefix[:-1]), placement.sizes,
                      placement.coords, seed, device)
