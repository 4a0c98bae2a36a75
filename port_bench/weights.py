"""The weights of a transformer cell, made by the benchmark from the seed.

The tree is the port's parameter layout (layer-stacked ``[L, ...]`` leaves
under ``/``-joined paths), worked out here from the configuration file's
sizes alone, so that the harness hands the same tensors to the program and
the reference without taking either from the other. The harness checks the
layout against the program's own shapes before a run.

The values come from one ``torch.randn`` call on the device, seeded by
``--seed``, cut into the leaves and scaled in place: weights at sigma 0.02,
the residual output projections at 0.02 / sqrt(2L), biases at 0.02 (not zero,
so that a dropped bias shows), norm scales at 1 + 0.1 N.
"""

from __future__ import annotations

import math

import torch


def layout(cfg: dict) -> list[tuple[str, tuple, float, float]]:
    """(path, shape, scale, offset) of every leaf, in sorted path order:
    the value is ``offset + scale * N(0, 1)``."""
    h, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    n = cfg["num_attention_heads"]
    d, m = h // n, cfg["intermediate_size"]
    V, P = cfg["vocab_size"], cfg["max_position_embeddings"]
    w, out = 0.02, 0.02 / math.sqrt(2 * L)
    leaves = {
        "embed/tokens": ((V, h), w, 0.0),
        "embed/pos": ((P, h), w, 0.0),
        "final_norm/scale": ((h,), 0.1, 1.0),
        "final_norm/bias": ((h,), w, 0.0),
        "layers/attn_norm/scale": ((L, h), 0.1, 1.0),
        "layers/attn_norm/bias": ((L, h), w, 0.0),
        "layers/mlp_norm/scale": ((L, h), 0.1, 1.0),
        "layers/mlp_norm/bias": ((L, h), w, 0.0),
        "layers/attn/wq": ((L, h, n, d), w, 0.0),
        "layers/attn/wk": ((L, h, n, d), w, 0.0),
        "layers/attn/wv": ((L, h, n, d), w, 0.0),
        "layers/attn/wo": ((L, n, d, h), out, 0.0),
        "layers/attn/bq": ((L, n, d), w, 0.0),
        "layers/attn/bk": ((L, n, d), w, 0.0),
        "layers/attn/bv": ((L, n, d), w, 0.0),
        "layers/attn/bo": ((L, h), w, 0.0),
        "layers/mlp/wi": ((L, h, m), w, 0.0),
        "layers/mlp/wo": ((L, m, h), out, 0.0),
        "layers/mlp/bi": ((L, m), w, 0.0),
        "layers/mlp/bo": ((L, h), w, 0.0),
    }
    return [(path, *leaves[path]) for path in sorted(leaves)]


def make(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """``{path: f32 tensor}`` from ``seed``: one draw on ``device`` for the
    whole tree, each leaf a view of it."""
    spec = layout(cfg)
    total = sum(math.prod(shape) for _, shape, _, _ in spec)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for path, shape, scale, offset in spec:
        size = math.prod(shape)
        leaf = flat[at:at + size].view(shape)
        leaf.mul_(scale)
        if offset:
            leaf.add_(offset)
        out[path] = leaf
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
