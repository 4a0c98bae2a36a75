"""Built-in partition rule sets for the model zoo — counterpart of
``polyaxon_tpu/partition/builtins.py``, copied pattern for pattern.

Each set is declarative data — ordered ``(regex, PartitionSpec)`` pairs over
/-joined param paths — that reproduces the logical-axis ``ShardingRules``
specs of the port's Tasks exactly (checked for every zoo model by
:func:`.plan.audit`): embed dims fsdp-shard (zero-3 style), heads/mlp/vocab
dims tensor-shard over ``model``, expert dims over ``expert``,
activations/norms replicate.
"""

from __future__ import annotations

from typing import Any

import torch

from ..parallel.mesh import PartitionSpec as P

# -- transformer core (llama / gpt2 / bert share one param tree) ------------
# Paths come from models/transformer.py abstract_params(): layer weights are
# stacked with a leading L dim (never sharded -> leading None).

TRANSFORMER_RULES: tuple[tuple[str, P], ...] = (
    (r"embed/tokens$", P("model", "fsdp")),          # (vocab, embed)
    (r"embed/pos$", P(None, "fsdp")),                # (max_seq, embed)
    (r"(attn_norm|mlp_norm|final_norm)/(scale|bias)$", P()),
    (r"attn/w[qkv]$", P(None, "fsdp", "model", None)),  # (L, embed, heads, hd)
    (r"attn/wo$", P(None, "model", None, "fsdp")),   # (L, heads, hd, embed)
    (r"attn/b[qkv]$", P(None, "model", None)),       # (L, heads, hd)
    (r"attn/bo$", P()),                              # (L, embed_act)
    (r"mlp/(wi|wg)$", P(None, "fsdp", "model")),     # (L, embed, mlp)
    (r"mlp/wo$", P(None, "model", "fsdp")),          # (L, mlp, embed)
    (r"mlp/bi$", P(None, "model")),                  # (L, mlp)
    (r"mlp/bo$", P()),                               # (L, embed_act)
    (r"lm_head/w$", P("fsdp", "model")),             # (embed, vocab)
)

# MoE layers replace the dense MLP: expert-stacked weights shard over the
# `expert` axis; these sit FIRST so first-match-wins picks them over the
# dense mlp/* rules of the shared tail.
TRANSFORMER_MOE_RULES: tuple[tuple[str, P], ...] = (
    (r"mlp/router$", P(None, "fsdp")),               # (L, embed, E)
    (r"mlp/(wi|wg)$", P(None, "expert", "fsdp", "model")),  # (L, E, embed, mlp)
    (r"mlp/wo$", P(None, "expert", "model", "fsdp")),       # (L, E, mlp, embed)
) + TRANSFORMER_RULES

# ViT: transformer encoder under encoder/ (the shared tail matches through
# the prefix) plus patchify / CLS / classification head.
VIT_RULES: tuple[tuple[str, P], ...] = (
    (r"patch/w$", P(None, "fsdp")),                  # (patch_dim, embed)
    (r"patch/b$", P()),
    (r"^cls$", P()),
    (r"head/w$", P("fsdp", None)),                   # (embed, classes)
    (r"head/b$", P()),
) + TRANSFORMER_RULES

# ResNet: conv kernels / BN params replicate wholesale (convs are small
# beside the activations).
RESNET_RULES: tuple[tuple[str, P], ...] = (
    (r".*", P()),
)

# LoRA adapters (partition/lora.py): tiny relative to the base, replicated
# by default; a user partition_rules block may still re-shard them over
# fsdp (the adapters ride the same engine under the lora/ prefix).
LORA_RULES: tuple[tuple[str, P], ...] = (
    (r"^lora/", P()),
)


def rules_for_config(family: str, cfg: Any) -> tuple[tuple[str, P], ...]:
    """The shipped rule set for one model-zoo (family, config) entry."""
    if family in ("lm", "mlm"):
        if getattr(cfg, "num_experts", 0):
            return TRANSFORMER_MOE_RULES
        return TRANSFORMER_RULES
    if family == "vit":
        return VIT_RULES
    if family == "resnet":
        return RESNET_RULES
    raise KeyError(f"no built-in partition rules for model family {family!r}")


def registry_entry(model_name: str) -> tuple[str, Any]:
    """The zoo's (family, config) of a model; KeyError on an unknown name."""
    from ..models import REGISTRY

    if model_name not in REGISTRY:
        raise KeyError(
            f"unknown model {model_name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[model_name]


def rules_for(model_name: str) -> tuple[tuple[str, P], ...]:
    return rules_for_config(*registry_entry(model_name))


# ---------------------------------------------------------------------------
# Abstract parameter trees (shapes and dtypes, no parameter memory)
# ---------------------------------------------------------------------------


def abstract_params_for_config(family: str, cfg: Any) -> Any:
    """A model's param tree as ``meta`` tensors (shapes and dtypes, no
    storage): the transformer's shape math for lm/mlm, the init on the
    meta device for vit/resnet. Validation and plans run anywhere."""
    if family in ("lm", "mlm"):
        from ..models import transformer

        def build(tree):
            if transformer._is_leaf(tree):
                return torch.empty(tree[0], dtype=cfg.param_dtype, device="meta")
            return {k: build(v) for k, v in tree.items()}

        return build(transformer.abstract_params(cfg))
    if family == "vit":
        from ..models import vit as vit_mod

        return vit_mod.init(cfg, device="meta")
    if family == "resnet":
        from ..models import resnet as resnet_mod

        return resnet_mod.init(cfg, device="meta")[0]
    raise KeyError(f"no abstract param tree for model family {family!r}")


def abstract_params_for(model_name: str) -> Any:
    return abstract_params_for_config(*registry_entry(model_name))
