"""Carry a JAX param tree into the port.

``params_from_jax(tree)`` takes the JAX package's parameter tree with its
leaves as numpy arrays (the ``abstract_params`` layout: nested dicts,
layer-stacked ``[L, ...]`` leaves) and returns the same tree of torch
tensors on ``device``. The layouts are identical, so the conversion is
leaf by leaf; the tests use it to give both packages the same weights.
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


def params_from_jax(tree: Any, *, device: Any) -> dict:
    """Nested dict of array-likes -> the same nested dict of tensors
    (same dtypes) on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device=device) for k, v in tree.items()}
    return _leaf(tree, torch.device(device))
