"""Llama-2 family configs for the port — the same architecture constants
as ``polyaxon_tpu/models/llama.py`` (dense and mixture-of-experts), with
torch dtypes."""

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

# Mixtral-style sparse MoE (the public 8x7B constants): 8 experts, top-2
# routing, the 7B trunk with GQA 32/8 and a 32k context.
MIXTRAL_8X7B = replace(
    LLAMA2_7B, vocab_size=32000, hidden=4096, num_layers=32, num_heads=32,
    num_kv_heads=8, mlp_dim=14336, max_seq=32768, rope_theta=1e6,
    num_experts=8, expert_top_k=2,
)

LLAMA_MOE_TINY = replace(LLAMA_TINY, num_experts=4, expert_top_k=2, mlp_dim=64)

# ~1.1B total / ~0.36B active sparse MoE: 16 layers, hidden 1024, 8
# experts of mlp 2560, top-2.
LLAMA_MOE_1B = replace(
    LLAMA2_7B, hidden=1024, num_layers=16, num_heads=16, num_kv_heads=4,
    mlp_dim=2560, max_seq=2048, num_experts=8, expert_top_k=2,
)

CONFIGS = {
    "llama2-7b": LLAMA2_7B,
    "llama2-13b": LLAMA2_13B,
    "llama2-70b": LLAMA2_70B,
    "llama-tiny": LLAMA_TINY,
    "llama-125m": LLAMA_125M,
    "llama-1b": LLAMA_1B,
    "mixtral-8x7b": MIXTRAL_8X7B,
    "llama-moe-tiny": LLAMA_MOE_TINY,
    "llama-moe-1b": LLAMA_MOE_1B,
}
