"""Training tasks of the port — counterpart of ``polyaxon_tpu/train/tasks.py``.
A Task owns init, the per-leaf PartitionSpecs of its params (the JAX
package's logical rules), the loss (with its metrics and the new non-param
state) and the throughput units the meter needs: tokens for the language
models, samples for vision. An MoE model's loss adds the router's Switch
balance term, and its metrics carry the balance and the dropped fraction.

Under a mesh (``loss(..., mesh=)``) the batch is this rank's rows (and,
under ``context``, its chunk of the sequence), and the loss and every
metric are this rank's share of the whole batch's value: the shares of the
batch and context ranks sum to it (a mean's numerator over the batch's
count). Under ``model`` every model rank computes the same loss from its
shards of the layers.

Which mesh axes a family's model shards over is the family's: the
transformers' layers over ``model`` and ``stage``, the token models' and
ViT's sequence over ``context``, the experts over ``expert``. ResNet
replicates every param (the JAX package's rules), so its compute is
replicated over ``model`` and ``context``: every such rank draws the same
rows and computes the same loss, and its loss, metrics, grads and batch
statistics are the batch axes' alone (``token_axes``). A mesh a model
cannot run on raises the JAX package's own error
(:func:`refuse_unsupported_axes`).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Optional

import torch

from ..models import resnet as resnet_mod
from ..models import transformer
from ..models import vit as vit_mod
from ..models.transformer import TransformerConfig
from ..parallel.blocks import init_tree
from ..parallel.mesh import BATCH_AXES, TOKEN_AXES, PartitionSpec, ShardingRules


def family_of(model_cfg: Any) -> str:
    """The registry family of a model config (``lm`` for a transformer:
    the LM and MLM tasks share it)."""
    if isinstance(model_cfg, vit_mod.ViTConfig):
        return "vit"
    if isinstance(model_cfg, resnet_mod.ResNetConfig):
        return "resnet"
    return "lm"


def refuse_unsupported_axes(model_cfg: Any, sizes: dict) -> None:
    """Raise on a mesh the model cannot run on, with the JAX package's
    errors: a ViT sequence (patches + CLS) that a ``context`` axis does not
    divide (its shard_map's), a trunk whose layers do not divide over
    ``stage``, a model without a layered trunk under ``stage`` and
    all-to-all experts that do not divide over ``expert``."""
    family = family_of(model_cfg)
    cp = int(sizes.get("context", 1))
    stages = int(sizes.get("stage", 1))
    if stages > 1:
        if family == "resnet":
            raise NotImplementedError("pipeline parallelism needs a layered transformer "
                                      "trunk; ResNetTask has none")
        trunk = model_cfg.encoder if family == "vit" else model_cfg
        if trunk.num_layers % stages:
            raise ValueError(f"{trunk.num_layers} layers do not divide over {stages} stages")
    ep = int(sizes.get("expert", 1))
    if (family == "lm" and model_cfg.num_experts and model_cfg.moe_dispatch == "a2a"
            and model_cfg.num_experts % ep):
        raise ValueError(f"num_experts {model_cfg.num_experts} not divisible by expert "
                         f"mesh axis {ep}")
    if family == "vit" and cp > 1 and (model_cfg.num_patches + 1) % cp:
        raise ValueError(
            f"shard_map applied to the function '_attn' was given argument arrays with "
            f"axis sizes that are not evenly divisible by the corresponding mesh axis "
            f"sizes: the sequence of {model_cfg.num_patches + 1} tokens over a "
            f"'context' axis of {cp}")


class Task(ABC):
    """One trainable workload family. Its params (and non-param state) are
    a tree of init laws (``parallel/blocks.py``): :meth:`init` evaluates
    them whole, and the trainer evaluates each rank's block of them."""

    #: DataConfig.kind to default to when the spec names none
    default_data_kind: str = "synthetic-lm"

    @abstractmethod
    def param_laws(self) -> Any:
        """The tree of the params' :class:`~..parallel.blocks.Law`."""

    def extra_laws(self) -> Any:
        """The laws of the non-param state (None: the model has none)."""
        return None

    def init(self, seed: int, device) -> tuple[Any, Any]:
        """Returns (params, extra), every leaf whole; extra is None when the
        model has no non-param state."""
        return (init_tree(self.param_laws(), seed, device),
                init_tree(self.extra_laws(), seed, device))

    @abstractmethod
    def param_specs(self, rules: ShardingRules) -> Any:
        """The PartitionSpec tree of the params."""

    def extra_specs(self, rules: ShardingRules) -> Any:
        return None  # replicated

    def abstract_params(self) -> Any:
        """The param tree as ``meta`` tensors: shapes and dtypes, no
        storage."""
        return init_tree(self.param_laws(), 0, "meta")

    @abstractmethod
    def loss(self, params: Any, extra: Any, batch: dict,
             mesh=None) -> tuple[torch.Tensor, dict, Any]:
        """Returns (scalar loss, metrics dict, new_extra)."""

    @abstractmethod
    def tokens_per_step(self, batch_size: int, seq_len: int) -> int: ...

    @abstractmethod
    def flops_per_token(self, seq_len: int) -> float: ...


def _accuracy(logits: torch.Tensor, labels: torch.Tensor, mesh=None,
              axes: tuple = TOKEN_AXES) -> torch.Tensor:
    return resnet_mod.batch_mean((torch.argmax(logits, dim=-1) == labels).float(), mesh,
                                 axes)


class LMTask(Task):
    """Next-token (causal) or masked (bidirectional, when the batch carries
    a loss mask) language modeling on the shared transformer core."""

    def __init__(self, cfg: TransformerConfig):
        self.cfg = cfg

    def param_laws(self):
        return transformer.param_laws(self.cfg)

    def param_specs(self, rules):
        return transformer.param_specs(self.cfg, rules)

    def loss(self, params, extra, batch, mesh=None):
        hidden, aux = transformer.apply_hidden(params, batch["inputs"], self.cfg, mesh=mesh,
                                               return_aux=True)
        w, vocab_major = transformer.head_weights(params, self.cfg)
        loss = transformer.lm_loss_from_hidden(
            hidden, w, batch["labels"], batch.get("mask"),
            vocab_major=vocab_major, chunk_tokens=self.cfg.loss_chunk_tokens, mesh=mesh)
        metrics = {"loss": loss}
        if self.cfg.num_experts:
            # this rank's share: the token ranks' shares sum to the batch's
            # value (a global balance is every rank's alike; a local drop
            # fraction averages, as the JAX package's pmean does)
            shares = mesh.axis_size(*TOKEN_AXES) if mesh is not None else 1
            balance, drop = aux[0] / shares, aux[1] / shares
            if self.cfg.router_aux_coef:
                loss = loss + self.cfg.router_aux_coef * balance
            metrics["router_aux"] = balance
            metrics["router_drop_frac"] = drop
        return loss, metrics, None

    def tokens_per_step(self, batch_size, seq_len):
        return batch_size * seq_len

    def flops_per_token(self, seq_len):
        return self.cfg.flops_per_token(seq_len)


class MLMTask(LMTask):
    """BERT-style MLM: the same core, a bidirectional config, masked batches
    (data kind synthetic-mlm supplies inputs, labels and mask)."""

    default_data_kind = "synthetic-mlm"


class ViTTask(Task):
    """Image classification with a ViT encoder."""

    default_data_kind = "synthetic-image"

    def __init__(self, cfg: vit_mod.ViTConfig):
        self.cfg = cfg

    def param_laws(self):
        return vit_mod.param_laws(self.cfg)

    def param_specs(self, rules):
        return vit_mod.param_specs(self.cfg, rules)

    def loss(self, params, extra, batch, mesh=None):
        logits = vit_mod.apply(params, batch["images"], self.cfg, mesh)
        loss = resnet_mod.classification_loss(logits, batch["labels"], mesh)
        return loss, {"loss": loss,
                      "accuracy": _accuracy(logits, batch["labels"], mesh)}, None

    def tokens_per_step(self, batch_size, seq_len):
        return batch_size  # samples

    def flops_per_token(self, seq_len):
        # per image: the encoder's FLOPs at its sequence (patches + CLS)
        tokens = self.cfg.num_patches + 1
        return self.cfg.encoder.flops_per_token(tokens) * tokens


class ResNetTask(Task):
    """ResNet classification; the batch statistics are ``extra``, updated by
    every microbatch's forward."""

    default_data_kind = "synthetic-image"
    #: the compute is replicated over ``model`` and ``context``
    token_axes = BATCH_AXES

    def __init__(self, cfg: resnet_mod.ResNetConfig, image_size: Optional[int] = None):
        self.cfg = cfg
        self.image_size = image_size or (32 if cfg.small_inputs else 224)

    def param_laws(self):
        return resnet_mod.laws(self.cfg)[0]

    def extra_laws(self):
        return resnet_mod.laws(self.cfg)[1]

    def param_specs(self, rules):
        # conv kernels replicate, as in the JAX package (small beside the
        # activations)
        params = self.abstract_params()

        def build(tree):
            return ({k: build(v) for k, v in tree.items()} if isinstance(tree, dict)
                    else PartitionSpec())

        return build(params)

    def loss(self, params, extra, batch, mesh=None):
        logits, new_stats = resnet_mod.apply(params, extra, batch["images"], self.cfg,
                                             train=True, mesh=mesh)
        loss = resnet_mod.classification_loss(logits, batch["labels"], mesh, BATCH_AXES)
        return loss, {"loss": loss, "accuracy": _accuracy(logits, batch["labels"], mesh,
                                                          BATCH_AXES)}, new_stats

    def tokens_per_step(self, batch_size, seq_len):
        return batch_size  # samples

    def flops_per_token(self, seq_len):
        return resnet_mod.flops_per_image(self.cfg, self.image_size)


def task_for(family: str, model_cfg: Any, **kwargs: Any) -> Task:
    """Model-zoo family name -> Task (REGISTRY's family tags)."""
    if family == "lm":
        return LMTask(model_cfg)
    if family == "mlm":
        return MLMTask(model_cfg)
    if family == "vit":
        return ViTTask(model_cfg)
    if family == "resnet":
        return ResNetTask(model_cfg, **kwargs)
    raise ValueError(f"no task for model family {family!r}")
