"""Compute ops of the port: elementwise/normalization layers and paged
decode attention (CUDA kernel + plain version)."""

from .layers import apply_rope, gelu, layer_norm, rms_norm, rope_frequencies, swiglu
from .paged_attention import (
    dense_decode_attention, gather_blocks, launch_counts, paged_attention,
    paged_decode, paged_decode_plain, reset_launch_counts,
)

__all__ = [
    "apply_rope",
    "gelu",
    "layer_norm",
    "rms_norm",
    "rope_frequencies",
    "swiglu",
    "dense_decode_attention",
    "gather_blocks",
    "launch_counts",
    "paged_attention",
    "paged_decode",
    "paged_decode_plain",
    "reset_launch_counts",
]
