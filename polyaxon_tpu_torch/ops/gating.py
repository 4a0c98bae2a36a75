"""Bubble-tick compute gating for pipeline stage bodies — counterpart of
``polyaxon_tpu/ops/gating.py``.

A stage body wraps each matmul-heavy, collective-free segment in
:func:`gated`, so an inactive tick emits exact zeros while the collectives
between the segments run in one program order on every rank. ``active`` is
a Python bool here (a tick's activity depends only on the tick and the
stage index, both known on the host), so no conditional is traced: the
port's pipeline skips an idle tick outright under the ``full`` and
``inner`` gates, and a ``False`` gate is reached only by a caller that asks
for it (the C1 rule: an inactive body emits zeros).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch


def _zeros_like(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_zeros_like(t) for t in tree)
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return tree


def gated(active: Optional[bool], fn: Callable[..., Any], *args: Any) -> Any:
    """``fn(*args)`` when ``active`` is None or true; when false, exact
    zeros of ``fn``'s output structure, shapes and dtypes (taken from one
    run of ``fn`` without grad, the counterpart of JAX's ``eval_shape``).
    ``fn`` must be collective-free: it is the segment a tick skips."""
    if active is None or active:
        return fn(*args)
    with torch.no_grad():
        return _zeros_like(fn(*args))
