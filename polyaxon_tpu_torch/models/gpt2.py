"""GPT-2 family configs for the port — the same architecture constants as
``polyaxon_tpu/models/gpt2.py``, with torch dtypes: learned positions,
pre-LN, GELU, biases, tied embeddings."""

from __future__ import annotations

from dataclasses import replace

import torch

from .transformer import TransformerConfig

_BASE = dict(
    vocab_size=50257, max_seq=1024, norm="ln", act="gelu", pos="learned",
    causal=True, use_bias=True, tie_embeddings=True, eps=1e-5,
    dtype=torch.bfloat16,
)

GPT2_124M = TransformerConfig(hidden=768, num_layers=12, num_heads=12, mlp_dim=3072, **_BASE)
GPT2_345M = TransformerConfig(hidden=1024, num_layers=24, num_heads=16, mlp_dim=4096, **_BASE)
GPT2_774M = TransformerConfig(hidden=1280, num_layers=36, num_heads=20, mlp_dim=5120, **_BASE)
GPT2_1558M = TransformerConfig(hidden=1600, num_layers=48, num_heads=25, mlp_dim=6400, **_BASE)

GPT2_TINY = replace(
    GPT2_124M, vocab_size=256, hidden=64, num_layers=2, num_heads=4,
    mlp_dim=128, max_seq=128, dtype=torch.float32, attn_impl="dense",
)

CONFIGS = {
    "gpt2-124m": GPT2_124M,
    "gpt2-345m": GPT2_345M,
    "gpt2-774m": GPT2_774M,
    "gpt2-1558m": GPT2_1558M,
    "gpt2-tiny": GPT2_TINY,
}
