"""Elementwise and normalization building blocks (port of
``polyaxon_tpu/ops/layers.py``). Plain PyTorch: each is a handful of
elementwise passes next to much larger matrix products."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in f32 regardless of activation dtype."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    x = (x - mean) * torch.rsqrt(var + eps)
    return (x * weight.float() + bias.float()).to(dtype)


def rope_frequencies(head_dim: int, max_seq: int, theta: float = 10000.0,
                     device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [max_seq, head_dim//2] (f32)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    inv = 1.0 / (theta ** exps)
    t = torch.arange(max_seq, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotary position embedding, NeoX halves (not interleaved pairs).
    x: [..., seq, head_dim]; positions: [seq] or [B, seq] global indices."""
    seq = x.shape[-2]
    if positions is None:
        positions = torch.arange(seq, device=x.device)
    positions = positions.long()
    c, s = cos[positions], sin[positions]
    if x.ndim == 4:
        c, s = c.unsqueeze(-3), s.unsqueeze(-3)
    x1, x2 = x.float().chunk(2, dim=-1)
    while c.ndim < x1.ndim:
        c, s = c.unsqueeze(0), s.unsqueeze(0)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * x


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU, tanh approximation (JAX's ``approximate=True``)."""
    return F.gelu(x, approximate="tanh")
