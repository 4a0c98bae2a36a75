"""Llama-2 family configs (dense) for the port — the same architecture
constants as ``polyaxon_tpu/models/llama.py``, with torch dtypes."""

from __future__ import annotations

from dataclasses import replace

import torch

from .transformer import TransformerConfig

LLAMA2_7B = TransformerConfig(
    vocab_size=32000, hidden=4096, num_layers=32, num_heads=32,
    num_kv_heads=32, mlp_dim=11008, max_seq=4096, norm="rms", act="swiglu",
    pos="rope", causal=True, eps=1e-5, rope_theta=10000.0,
    dtype=torch.bfloat16, remat="dots",
)

LLAMA2_13B = replace(LLAMA2_7B, hidden=5120, num_layers=40, num_heads=40,
                     num_kv_heads=40, mlp_dim=13824)

LLAMA2_70B = replace(LLAMA2_7B, hidden=8192, num_layers=80, num_heads=64,
                     num_kv_heads=8, mlp_dim=28672)

# Small config for tests: f32, 2 layers, GQA 4/2.
LLAMA_TINY = replace(
    LLAMA2_7B, vocab_size=256, hidden=64, num_layers=2, num_heads=4,
    num_kv_heads=2, mlp_dim=128, max_seq=128, remat="none", dtype=torch.float32,
    attn_impl="dense",
)

LLAMA_125M = replace(
    LLAMA2_7B, vocab_size=32000, hidden=768, num_layers=12, num_heads=12,
    num_kv_heads=12, mlp_dim=2048, max_seq=2048,
)

# ~1.1B with TinyLlama's architecture (hidden 2048, GQA 32/4, mlp 5632).
LLAMA_1B = replace(
    LLAMA2_7B, hidden=2048, num_layers=22, num_heads=32, num_kv_heads=4,
    mlp_dim=5632, max_seq=2048,
)

CONFIGS = {
    "llama2-7b": LLAMA2_7B,
    "llama2-13b": LLAMA2_13B,
    "llama2-70b": LLAMA2_70B,
    "llama-tiny": LLAMA_TINY,
    "llama-125m": LLAMA_125M,
    "llama-1b": LLAMA_1B,
}
