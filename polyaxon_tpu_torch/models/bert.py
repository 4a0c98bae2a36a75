"""BERT MLM configs for the port — the same architecture constants as
``polyaxon_tpu/models/bert.py``, with torch dtypes: a bidirectional encoder
on the shared transformer core (``causal=False``), LayerNorm at eps 1e-12,
learned positions, biases and a tied head. The masked-LM loss counts only
the selected positions, through the loss mask."""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

import torch

from .transformer import TransformerConfig, cross_entropy_loss

BERT_BASE = TransformerConfig(
    vocab_size=30522, hidden=768, num_layers=12, num_heads=12, mlp_dim=3072,
    max_seq=512, norm="ln", act="gelu", pos="learned", causal=False,
    use_bias=True, tie_embeddings=True, eps=1e-12, dtype=torch.bfloat16,
)

BERT_LARGE = replace(BERT_BASE, hidden=1024, num_layers=24, num_heads=16, mlp_dim=4096)

BERT_TINY = replace(
    BERT_BASE, vocab_size=256, hidden=64, num_layers=2, num_heads=4,
    mlp_dim=128, max_seq=128, dtype=torch.float32, attn_impl="dense",
)

CONFIGS = {"bert-base": BERT_BASE, "bert-large": BERT_LARGE, "bert-tiny": BERT_TINY}

MASK_TOKEN_ID = 103  # [MASK] in the BERT WordPiece vocab


def mlm_mask_tokens(generator: torch.Generator, tokens: torch.Tensor, vocab_size: int,
                    mask_rate: float = 0.15, mask_token_id: int = MASK_TOKEN_ID,
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """BERT 80/10/10 masking with draws from ``generator`` (on the tokens'
    device). Returns (inputs, labels, loss_mask). The training path masks in
    the data stream (``synthetic_mlm_batches``) instead."""
    dev = tokens.device
    selected = torch.rand(tokens.shape, generator=generator, device=dev) < mask_rate
    roll = torch.rand(tokens.shape, generator=generator, device=dev)
    random_tokens = torch.randint(0, vocab_size, tokens.shape, generator=generator,
                                  device=dev, dtype=tokens.dtype)
    inputs = torch.where(selected & (roll < 0.8), torch.full_like(tokens, mask_token_id),
                         tokens)
    inputs = torch.where(selected & (roll >= 0.8) & (roll < 0.9), random_tokens, inputs)
    return inputs, tokens, selected


def mlm_loss(logits: torch.Tensor, labels: torch.Tensor,
             loss_mask: Optional[torch.Tensor]) -> torch.Tensor:
    return cross_entropy_loss(logits, labels, loss_mask)
