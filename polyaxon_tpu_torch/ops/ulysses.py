"""Ulysses (DeepSpeed-style) sequence parallelism — port of
``polyaxon_tpu/ops/ulysses.py``: the head-parallel alternative to ring
attention.

Each rank of the ``context`` group holds a chunk of the sequence of every
head. One all-to-all turns that into the whole sequence of heads/cp heads,
the port's ``attention()`` runs with the full mask, and a second
all-to-all turns it back. Both are differentiable (an all-to-all's
backward is the same exchange), so no custom backward is needed.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel.collectives import all_to_all
from .attention import attention


def ulysses_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *,
    group,
    size: int,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """q/k/v: this rank's chunk ``[batch, heads, seq_local, head_dim]`` of
    the ``size`` ranks of ``group`` (k/v with q's heads: expand GQA first)."""
    cp = int(size)
    b, h, s, d = q.shape
    if h % cp != 0:
        raise ValueError(f"Ulysses needs heads ({h}) divisible by axis size ({cp})")

    def to_heads(x):  # [B, H, S/cp, D] -> [B, H/cp, S, D]
        blocks = x.reshape(b, cp, h // cp, s, d).permute(1, 0, 2, 3, 4)
        got = all_to_all(blocks, group)  # block j: chunk j of the sequence
        return got.permute(1, 2, 0, 3, 4).reshape(b, h // cp, cp * s, d)

    def to_seq(x):  # [B, H/cp, S, D] -> [B, H, S/cp, D]
        blocks = x.reshape(b, h // cp, cp, s, d).permute(2, 0, 1, 3, 4)
        got = all_to_all(blocks, group)  # block j: heads group j
        return got.permute(1, 0, 2, 3, 4).reshape(b, h, s, d)

    o = attention(to_heads(q), to_heads(k), to_heads(v), causal=causal,
                  sm_scale=sm_scale, impl=impl)
    return to_seq(o)
