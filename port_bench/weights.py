"""The weights of a cell, made by the benchmark from the seed.

The tree is the port's parameter layout (layer-stacked ``[L, ...]`` leaves
under ``/``-joined paths). Each family's file ``layouts/<family>.py`` works
it out from the configuration file's sizes alone (``layout``), so that the
harness hands the same tensors to the program and the reference without
taking either from the other. The harness checks the layout against the
program's own shapes before a run.

The values come from one ``torch.randn`` call on the device, seeded by
``--seed``, cut into the leaves in sorted path order and scaled in place:
each leaf is ``offset + scale * N(0, 1)``, at the scales its layout gives.
"""

from __future__ import annotations

import math
from types import ModuleType
from typing import NamedTuple

import torch


class Leaf(NamedTuple):
    path: str
    shape: tuple
    scale: float
    offset: float
    stacked: bool     # layer-stacked: the first dim counts the layers


def leaves(family: ModuleType, cfg: dict) -> list[Leaf]:
    """The family's layout (``layouts/<family>.py``'s ``layout(cfg)``: path,
    shape, scale, offset and whether the leaf is layer-stacked), in sorted
    path order."""
    return sorted((Leaf(*leaf) for leaf in family.layout(cfg)), key=lambda leaf: leaf.path)


def stacked(spec: list[Leaf]) -> set:
    """The paths of the layer-stacked leaves."""
    return {leaf.path for leaf in spec if leaf.stacked}


def make(spec: list[Leaf], seed: int, device) -> dict[str, torch.Tensor]:
    """``{path: f32 tensor}`` from ``seed``: one draw on ``device`` for the
    whole tree, each leaf a view of it, in the order of ``spec``."""
    total = sum(math.prod(leaf.shape) for leaf in spec)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for leaf in spec:
        size = math.prod(leaf.shape)
        t = flat[at:at + size].view(leaf.shape)
        t.mul_(leaf.scale)
        if leaf.offset:
            t.add_(leaf.offset)
        out[leaf.path] = t
        at += size
    return out


def nest(flat: dict[str, torch.Tensor]) -> dict:
    """The ``/``-joined paths as the port's nested tree."""
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *parents, last = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def flat_paths(tree: dict, prefix: str = "") -> dict:
    """The nested tree's leaves by ``/``-joined path."""
    out = {}
    for key in sorted(tree):
        value = tree[key]
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(flat_paths(value, path + "/"))
        else:
            out[path] = value
    return out
