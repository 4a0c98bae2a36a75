"""Carry a JAX param tree into the port.

``params_from_jax(tree)`` takes a JAX package's tree with its leaves as
numpy arrays and returns the same tree of torch tensors on ``device``: the
transformer's (nested dicts, layer-stacked ``[L, ...]`` leaves), ViT's (no
``embed.tokens``), ResNet's ``(params, batch_stats)`` pair (HWIO kernels).
The port keeps every JAX layout, so the conversion is leaf by leaf and a
converted tree means the same thing in both packages; the tests use it to
give both the same weights.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _leaf(x, device) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own: widen (exactly) and narrow back
        t = torch.tensor(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.tensor(arr)
    return t.to(device)


def params_from_jax(tree: Any, *, device: Any) -> Any:
    """Nested dicts, lists and tuples of array-likes -> the same structure
    of tensors (same dtypes) on ``device``; None stays None (a model
    without batch statistics)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device=device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device=device) for v in tree)
    return _leaf(tree, torch.device(device))
