"""The partition engine of the port — counterpart of
``polyaxon_tpu/partition``.

- :mod:`rules` — the engine: ``match_partition_rules`` over /-joined param
  paths, first-match-wins, scalar auto-replicate, loud
  ``UnmatchedParamError``; ``partition_rules:`` parsing with
  ``RuleSyntaxError``.
- :mod:`builtins` — shipped rule sets per model family, equal to the
  Tasks' logical-axis specs.
- :mod:`convert` — foreign-checkpoint import/export (flat + HF-llama
  layouts).
- :mod:`lora` — LoRA adapters riding the same engine (frozen base,
  trainable low-rank deltas).
- :mod:`plan` — plan tables, run-output summaries, the rule-coverage
  audit (``python -m polyaxon_tpu_torch.partition``) and spec validation.
"""

from .builtins import (
    LORA_RULES,
    RESNET_RULES,
    TRANSFORMER_MOE_RULES,
    TRANSFORMER_RULES,
    VIT_RULES,
    abstract_params_for,
    abstract_params_for_config,
    rules_for,
    rules_for_config,
)
from .plan import (
    audit,
    build_plan,
    format_plan,
    needs_validation,
    plan_summary_from_shardings,
    validate_builtin_spec,
)
from .rules import (
    RuleSyntaxError,
    UnmatchedParamError,
    match_partition_rules,
    nearest_paths,
    overlay_partition_rules,
    parse_rules,
    path_str,
    rules_to_jsonable,
    spec_axes,
    specs_equivalent,
    tree_paths,
    validate_rules_against,
)

__all__ = [
    "LORA_RULES",
    "RESNET_RULES",
    "TRANSFORMER_MOE_RULES",
    "TRANSFORMER_RULES",
    "VIT_RULES",
    "RuleSyntaxError",
    "UnmatchedParamError",
    "abstract_params_for",
    "abstract_params_for_config",
    "audit",
    "build_plan",
    "format_plan",
    "match_partition_rules",
    "nearest_paths",
    "needs_validation",
    "overlay_partition_rules",
    "parse_rules",
    "path_str",
    "plan_summary_from_shardings",
    "rules_for",
    "rules_for_config",
    "rules_to_jsonable",
    "spec_axes",
    "specs_equivalent",
    "tree_paths",
    "validate_rules_against",
]
