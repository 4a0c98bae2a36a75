"""Training tasks of the port — counterpart of ``polyaxon_tpu/train/tasks.py``
for the dense causal LM. A Task owns init, the loss and the throughput
units the meter needs; the MLM, ViT and ResNet tasks and MoE's router loss
wait for ROADMAP A11 and A10.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any

import torch

from ..models import transformer
from ..models.transformer import TransformerConfig


class Task(ABC):
    """One trainable workload family."""

    #: DataConfig.kind to default to when the spec names none
    default_data_kind: str = "synthetic-lm"

    @abstractmethod
    def init(self, seed: int, device) -> tuple[Any, Any]:
        """Returns (params, extra); extra is None when the model has no
        non-param state."""

    @abstractmethod
    def loss(self, params: Any, extra: Any, batch: dict) -> tuple[torch.Tensor, dict, Any]:
        """Returns (scalar loss, metrics dict, new_extra)."""

    @abstractmethod
    def tokens_per_step(self, batch_size: int, seq_len: int) -> int: ...

    @abstractmethod
    def flops_per_token(self, seq_len: int) -> float: ...


class LMTask(Task):
    """Next-token language modeling on the shared transformer core."""

    def __init__(self, cfg: TransformerConfig):
        if getattr(cfg, "num_experts", 0):
            raise ValueError("MoE models are not ported (ROADMAP A10)")
        self.cfg = cfg

    def init(self, seed, device):
        return transformer.init(self.cfg, seed=seed, device=device), None

    def loss(self, params, extra, batch):
        hidden = transformer.apply_hidden(params, batch["inputs"], self.cfg)
        w, vocab_major = transformer.head_weights(params, self.cfg)
        loss = transformer.lm_loss_from_hidden(
            hidden, w, batch["labels"], batch.get("mask"),
            vocab_major=vocab_major, chunk_tokens=self.cfg.loss_chunk_tokens)
        return loss, {"loss": loss}, None

    def tokens_per_step(self, batch_size, seq_len):
        return batch_size * seq_len

    def flops_per_token(self, seq_len):
        return self.cfg.flops_per_token(seq_len)


def task_for(family: str, model_cfg: Any) -> Task:
    """Model-zoo family name -> Task (REGISTRY's family tags)."""
    if family == "lm":
        return LMTask(model_cfg)
    raise ValueError(f"no task for model family {family!r} in the port")
