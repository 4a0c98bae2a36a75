"""Public attention API of the port: the dense reference, the flash
dispatch and GQA handling — port of ``polyaxon_tpu/ops/attention.py``.

Shapes are ``[batch, heads, seq, head_dim]`` throughout. The dense path is
the numerics oracle for the flash kernels and the small-shape fallback.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention_bhsd


def repeat_kv(k: torch.Tensor, num_q_heads: int) -> torch.Tensor:
    """Expand grouped KV heads to match query heads (GQA/MQA): each KV
    head repeats for its group in place (``jnp.repeat(..., axis=1)``)."""
    num_kv = k.shape[1]
    if num_kv == num_q_heads:
        return k
    if num_q_heads % num_kv:
        raise ValueError(f"{num_q_heads} query heads do not group over {num_kv} KV heads")
    return torch.repeat_interleave(k, num_q_heads // num_kv, dim=1)


def dense_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    q_offset: int = 0,
    k_offset: int = 0,
) -> torch.Tensor:
    """Plain attention in f32, with the flash kernels' global-position
    causal mask; rows that see no key are zeros."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    k = repeat_kv(k, q.shape[1])
    v = repeat_kv(v, q.shape[1])
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if causal:
        q_ids = q_offset + torch.arange(q.shape[2], device=q.device)
        k_ids = k_offset + torch.arange(k.shape[2], device=q.device)
        mask = q_ids[:, None] >= k_ids[None, :]
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0)  # fully-masked rows
    return torch.matmul(probs, v.float()).to(q.dtype)


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    impl: str = "auto",
    block_q: int = 512,
    block_k: int = 512,
    block_q_bwd: Optional[int] = None,
    block_k_bwd: Optional[int] = None,
) -> torch.Tensor:
    """Single-device attention entry point.

    ``impl``: 'flash' (the CUDA kernels, which raise on a dtype or head
    dim they do not take; their plain versions on the CPU), 'dense', or
    'auto': flash when s >= 128 and the fwd and bwd blocks divide both
    sequence lengths, dense otherwise, on every device.
    """
    b, h, s, d = q.shape
    if impl == "auto":
        sk = k.shape[2]
        # the bwd runs at its own blocks: a shape only the fwd blocks
        # divide must take the dense path, not fail in the backward
        divisible = all(
            dim % min(blk, dim) == 0
            for dim, blk in ((s, block_q), (sk, block_k),
                             (s, block_q_bwd or block_q),
                             (sk, block_k_bwd or block_k)))
        impl = "flash" if divisible and s >= 128 else "dense"
    if impl == "dense":
        return dense_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    if impl != "flash":
        raise ValueError(f"unknown attention impl {impl!r}; valid: auto|dense|flash")
    kr = repeat_kv(k, h)
    vr = repeat_kv(v, h)
    o = flash_attention_bhsd(
        q.reshape(b * h, s, d),
        kr.reshape(b * h, kr.shape[2], d),
        vr.reshape(b * h, vr.shape[2], d),
        causal=causal, sm_scale=sm_scale,
        block_q=block_q, block_k=block_k,
        block_q_bwd=block_q_bwd, block_k_bwd=block_k_bwd,
    )
    return o.reshape(b, h, s, d)
