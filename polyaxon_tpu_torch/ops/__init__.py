"""Compute ops of the port: elementwise/normalization layers, attention
(dense reference, flash dispatch, GQA) with the flash-attention CUDA
kernels, the pipeline's bubble-tick gate, and paged decode attention
(CUDA kernel + plain version)."""

from .attention import attention, dense_attention, repeat_kv
from .flash_attention import bwd_row_stats, flash_attention_bhsd
from .gating import gated
from .layers import apply_rope, gelu, layer_norm, rms_norm, rope_frequencies, swiglu
from .paged_attention import (
    dense_decode_attention, gather_blocks, launch_counts, paged_attention,
    paged_decode, paged_decode_plain, reset_launch_counts,
)

__all__ = [
    "attention",
    "dense_attention",
    "repeat_kv",
    "bwd_row_stats",
    "flash_attention_bhsd",
    "gated",
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
