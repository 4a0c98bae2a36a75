"""Partition planning, rule-coverage audit and spec validation of the port
— counterpart of ``polyaxon_tpu/partition/plan.py``.

Three consumers of the same resolution:

- :func:`build_plan` resolves the param -> PartitionSpec table and the
  per-device bytes of a model and mesh without building the mesh or
  touching a device (:func:`format_plan` renders it);
- the builtin runtime logs :func:`plan_summary_from_shardings` of the
  trainer's resolved specs (built-ins, the user overlay, the pipeline's
  layer cut) into the run's outputs;
- ``python -m polyaxon_tpu_torch.partition`` audits that every zoo model's
  whole param tree is matched by its shipped rule set AND that the engine
  reproduces the Tasks' logical-axis specs exactly.

:func:`validate_builtin_spec` checks a spec's ``lora:``, ``import:`` and
``partition_rules:`` blocks with the JAX package's error classes and
wording; the port has no compiler, so its runtime calls it before any
device work.
"""

from __future__ import annotations

import math
import re
from typing import Any, Optional, Sequence

import torch

from ..parallel.mesh import normalize_axis_sizes
from .builtins import (
    LORA_RULES,
    abstract_params_for_config,
    registry_entry,
    rules_for_config,
)
from .rules import (
    RuleSyntaxError,
    is_spec,
    match_partition_rules,
    normalize_spec,
    overlay_partition_rules,
    parse_rules,
    spec_axes,
    specs_equivalent,
    tree_paths,
    validate_rules_against,
)


def plan_axis_sizes(parallelism: Any, num_devices: Optional[int]) -> dict[str, int]:
    """Mirror build_mesh's capacity absorption so the plan's shard factors
    match what the runtime will actually build: unspecified capacity folds
    into ``data`` when the device count is known."""
    sizes = normalize_axis_sizes(parallelism)
    declared = math.prod(sizes.values())
    if num_devices and num_devices % declared == 0 \
            and num_devices // declared > 1 and sizes["data"] == 1:
        sizes["data"] = num_devices // declared
    return sizes


def _shard_factor(spec: Any, sizes: dict[str, int]) -> int:
    return math.prod(sizes.get(ax, 1) for ax in spec_axes(spec))


def _spec_str(spec: Any) -> str:
    entries = normalize_spec(spec)
    if not entries:
        return "replicated"
    return "(" + ", ".join(
        "+".join(e) if e is not None else "-" for e in entries) + ")"


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a dtype (``float32``, ``bfloat16``)."""
    return str(dtype).removeprefix("torch.")


def _leaf_bytes(leaf: Any) -> tuple[int, int]:
    """(elements, bytes) of a leaf."""
    n = int(math.prod(leaf.shape)) if leaf.shape else 1
    return n, n * leaf.dtype.itemsize


def _with_lora(abstract: Any, lora: Any) -> Any:
    """``{"base", "lora"}`` around a base tree; raises LoRATargetError
    (with the nearest paths) on a bad target."""
    from .lora import LoRAConfig, init_lora

    lcfg = LoRAConfig.from_spec(lora)
    return {"base": abstract, "lora": init_lora(abstract, lcfg, device="meta")}


def build_plan(
    model: str,
    *,
    parallelism: Any = None,
    num_devices: Optional[int] = None,
    num_slices: int = 1,
    partition_rules: Any = None,
    lora: Any = None,
) -> dict:
    """Resolve the full param -> PartitionSpec table for a model + mesh
    without building the mesh or touching a device. Returns ``{"rows":
    [...], "summary": {...}}`` (JSON-able)."""
    family, cfg = registry_entry(model)
    abstract = abstract_params_for_config(family, cfg)
    base_rules = rules_for_config(family, cfg)
    if lora:
        abstract = _with_lora(abstract, lora)
        # adapters match "^lora/..." first; the model set's unanchored
        # patterns match straight through the "base/" prefix
        base_rules = LORA_RULES + base_rules
    specs = match_partition_rules(base_rules, abstract)
    user_rules = parse_rules(partition_rules) if partition_rules else ()
    if user_rules:
        specs = overlay_partition_rules(user_rules, abstract, specs)

    sizes = plan_axis_sizes(parallelism, num_devices)
    rows = []
    total_params = 0
    total_bytes = 0
    shard_bytes = 0
    axes_used: set[str] = set()
    for (path, leaf), (_, spec) in zip(tree_paths(abstract),
                                       tree_paths(specs, is_leaf=is_spec)):
        n, nbytes = _leaf_bytes(leaf)
        factor = _shard_factor(spec, sizes)
        rows.append({
            "param": path,
            "shape": list(leaf.shape),
            "dtype": _dtype_name(leaf.dtype),
            "spec": _spec_str(spec),
            "bytes": nbytes,
            "bytes_per_device": nbytes // factor,
        })
        total_params += n
        total_bytes += nbytes
        shard_bytes += nbytes // factor
        axes_used.update(ax for ax in spec_axes(spec) if sizes.get(ax, 1) > 1)
    return {
        "rows": rows,
        "summary": {
            "model": model,
            "num_params": total_params,
            "num_tensors": len(rows),
            "total_bytes": total_bytes,
            "bytes_per_device": shard_bytes,
            "axes_used": sorted(axes_used),
            "axis_sizes": {k: v for k, v in sizes.items() if v > 1},
            "num_devices": num_devices,
            "num_slices": num_slices,
            "user_rules": len(user_rules),
        },
    }


def plan_for_builtin_spec(builtin: dict, *, num_devices: Optional[int] = None,
                          num_slices: int = 1) -> dict:
    """:func:`build_plan` of a compiled builtin spec (the dict a pod gets
    in ``PLX_BUILTIN_SPEC``: the runtime block with the run's parallelism
    and partition rules merged in), with the precedence of the JAX
    ``polyaxon partition plan`` verb: ``num_devices`` and ``num_slices``
    are the topology's, and the spec's own ``num_slices`` wins over the
    topology's."""
    if not builtin or not isinstance(builtin, dict):
        raise ValueError("partition plan needs a `runtime:` builtin-trainer block "
                         "(user containers own their own sharding)")
    if builtin.get("num_slices") is not None:
        num_slices = int(builtin["num_slices"])
    return build_plan(
        builtin.get("model", "llama-tiny"),
        parallelism=builtin.get("parallelism"),
        num_devices=num_devices,
        num_slices=num_slices,
        partition_rules=builtin.get("partition_rules"),
        lora=builtin.get("lora"),
    )


def format_plan(plan: dict) -> str:
    rows = plan["rows"]
    s = plan["summary"]
    w_path = max([len(r["param"]) for r in rows] + [5])
    w_shape = max([len(str(tuple(r["shape"]))) for r in rows] + [5])
    w_spec = max([len(r["spec"]) for r in rows] + [4])
    lines = [
        f"{'param':<{w_path}}  {'shape':<{w_shape}}  {'dtype':<8}  "
        f"{'spec':<{w_spec}}  {'bytes/device':>12}",
        "-" * (w_path + w_shape + w_spec + 36),
    ]
    for r in rows:
        lines.append(
            f"{r['param']:<{w_path}}  {str(tuple(r['shape'])):<{w_shape}}  "
            f"{r['dtype']:<8}  {r['spec']:<{w_spec}}  "
            f"{r['bytes_per_device']:>12,}")
    lines.append("-" * (w_path + w_shape + w_spec + 36))
    axis = ", ".join(f"{k}={v}" for k, v in s["axis_sizes"].items()) or "none"
    lines.append(
        f"{s['model']}: {s['num_params']:,} params in {s['num_tensors']} "
        f"tensors; {s['total_bytes']:,} bytes total, "
        f"{s['bytes_per_device']:,} bytes/device "
        f"(mesh axes {axis}; sharded over {s['axes_used'] or ['nothing']}"
        f"; {s['num_slices']} slice(s))")
    return "\n".join(lines)


def plan_summary_from_shardings(abstract: Any, specs: Any, mesh: Any) -> dict:
    """The runtime-side mirror: summarize the trainer's RESOLVED specs
    (built-ins, user overlay, the pipeline's layer cut; ``Trainer.specs``)
    over its mesh, so run outputs show what actually launched."""
    sizes = dict(mesh.sizes)
    total_params = 0
    total_bytes = 0
    shard_bytes = 0
    axes_used: set[str] = set()
    for (path, leaf), (_, spec) in zip(tree_paths(abstract),
                                       tree_paths(specs, is_leaf=is_spec)):
        n, nbytes = _leaf_bytes(leaf)
        factor = _shard_factor(spec, sizes)
        total_params += n
        total_bytes += nbytes
        shard_bytes += nbytes // factor
        axes_used.update(ax for ax in spec_axes(spec) if sizes.get(ax, 1) > 1)
    return {
        "num_params": total_params,
        "total_bytes": total_bytes,
        "bytes_per_device": shard_bytes,
        "axes_used": sorted(axes_used),
        "num_devices": int(mesh.size),
    }


# ---------------------------------------------------------------------------
# Spec validation (before any device work)
# ---------------------------------------------------------------------------

_PARTITION_KEYS = ("partition_rules", "lora", "import")


def needs_validation(builtin: dict) -> bool:
    return any(k in builtin for k in _PARTITION_KEYS)


def _validate_import(imp: Any, model: str, family: str, cfg: Any) -> None:
    if not isinstance(imp, dict) or not imp.get("path"):
        raise RuleSyntaxError(
            "import: must be a mapping with at least a 'path' key")
    if family not in ("lm", "mlm"):
        raise RuleSyntaxError(
            f"import: is only supported for transformer LM/MLM models; "
            f"{model!r} is family {family!r}")
    layout = imp.get("layout", "auto")
    if layout not in ("auto", "flat", "hf-llama"):
        raise RuleSyntaxError(
            f"import: unknown layout {layout!r}; valid: auto | flat | "
            f"hf-llama")
    if layout == "hf-llama":
        from .convert import ImportError_, _hf_llama_check

        try:
            _hf_llama_check(cfg)
        except ImportError_ as e:
            raise RuleSyntaxError(f"import: {e}") from e
    if imp.get("dtype") is not None:
        from .convert import ImportError_, _torch_dtype

        try:
            _torch_dtype(imp["dtype"])
        except ImportError_ as e:
            raise RuleSyntaxError(
                f"import: unknown dtype {imp['dtype']!r}") from e
    for field, second in (("key_map", "replacement"),
                          ("transpose", "axis list")):
        for entry in imp.get(field) or []:
            if not isinstance(entry, (list, tuple)) or len(entry) != 2:
                raise RuleSyntaxError(
                    f"import: {field} entry {entry!r} must be a "
                    f"[regex, {second}] pair")
            pattern = entry[0]
            try:
                re.compile(pattern)
            except re.error as e:
                raise RuleSyntaxError(
                    f"import: {field} regex {pattern!r} does not "
                    f"compile: {e}", rule=pattern) from e
            if field == "transpose" and (
                    not isinstance(entry[1], (list, tuple))
                    or not all(isinstance(a, int) for a in entry[1])):
                raise RuleSyntaxError(
                    f"import: transpose axes {entry[1]!r} must be a "
                    f"list of ints")


def validate_builtin_spec(builtin: dict) -> None:
    """Validate a builtin-runtime spec's partition/lora/import blocks:
    rule-syntax errors carry the offending regex, rules that match nothing
    carry the nearest real param paths, and full-tree coverage is
    re-checked — every failure before a device is touched."""
    model = builtin.get("model", "llama-tiny")
    try:
        family, cfg = registry_entry(model)
    except KeyError as e:
        raise RuleSyntaxError(f"partition validation: {e.args[0]}") from e
    abstract = abstract_params_for_config(family, cfg)

    lora_spec = builtin.get("lora")
    if lora_spec:
        if family not in ("lm", "mlm"):
            raise RuleSyntaxError(
                f"lora: is only supported for transformer LM/MLM models; "
                f"{model!r} is family {family!r}")
        abstract = _with_lora(abstract, lora_spec)

    imp = builtin.get("import")
    if imp is not None:
        _validate_import(imp, model, family, cfg)

    raw_rules = builtin.get("partition_rules")
    if raw_rules:
        user_rules = parse_rules(raw_rules)  # RuleSyntaxError w/ regex
        validate_rules_against(user_rules, tree_paths(abstract))


# ---------------------------------------------------------------------------
# Rule-coverage audit
# ---------------------------------------------------------------------------


def audit(models: Optional[Sequence[str]] = None) -> dict[str, dict]:
    """For every zoo model: (a) the shipped rule set matches the FULL
    param tree (UnmatchedParamError otherwise — no silent replicate
    fallback), and (b) the engine's specs are EQUIVALENT to the port's
    Task specs (``Task.param_specs``; drift otherwise). Returns a per-model
    report; raises on the first failing model."""
    from ..models import REGISTRY
    from ..parallel.mesh import ShardingRules
    from ..train.tasks import task_for

    report: dict[str, dict] = {}
    for name in sorted(models or REGISTRY):
        family, cfg = registry_entry(name)
        abstract = abstract_params_for_config(family, cfg)
        rules = rules_for_config(family, cfg)
        specs = match_partition_rules(rules, abstract)  # raises on gaps
        oracle = task_for(family, cfg).param_specs(ShardingRules())
        drift = []
        for (path, _), (_, got), (_, want) in zip(
                tree_paths(abstract),
                tree_paths(specs, is_leaf=is_spec),
                tree_paths(oracle, is_leaf=is_spec)):
            if not specs_equivalent(got, want):
                drift.append(
                    f"{path}: engine {_spec_str(got)} != "
                    f"task {_spec_str(want)}")
        if drift:
            raise AssertionError(
                f"partition audit: {name} engine specs drifted from the Task "
                f"specs:\n" + "\n".join(f"  - {d}" for d in drift))
        report[name] = {
            "params": len(tree_paths(abstract)),
            "rules": len(rules),
            "status": "ok",
        }
    return report
