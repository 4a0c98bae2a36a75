"""Partition tools: ``python -m polyaxon_tpu_torch.partition``.

Rule-coverage audit, ``python -m polyaxon_tpu_torch.partition [models...]``:
exit 0 iff every zoo model's (or each named model's) full param tree is
matched by its shipped rule set AND the engine's specs equal the port's
``Task.param_specs`` — so a model edit cannot silently fall back to
replicated.

Plan, ``python -m polyaxon_tpu_torch.partition plan [--spec PATH]
[--num-devices N] [--num-slices S] [--json]``: the resolved param ->
PartitionSpec table and bytes per device of a compiled builtin spec —
the JSON a pod gets in ``PLX_BUILTIN_SPEC``, read from ``--spec`` or from
that env — before anything is launched, as the JAX ``polyaxon partition
plan`` verb prints it for a polyaxonfile. ``--num-devices`` and
``--num-slices`` are the topology's; the spec's own ``num_slices`` wins.

Shape math only: no device is touched."""

from __future__ import annotations

import argparse
import json
import os
import sys


def plan_main(argv: list[str]) -> int:
    from .plan import format_plan, plan_for_builtin_spec
    from .rules import RuleSyntaxError

    p = argparse.ArgumentParser(prog="python -m polyaxon_tpu_torch.partition plan")
    p.add_argument("--spec", default=None,
                   help="a JSON file of the compiled builtin spec "
                        "(default: $PLX_BUILTIN_SPEC)")
    p.add_argument("--num-devices", type=int, default=None)
    p.add_argument("--num-slices", type=int, default=1)
    p.add_argument("--json", dest="as_json", action="store_true",
                   help="emit the plan as JSON instead of a table")
    args = p.parse_args(argv)
    if args.spec:
        with open(args.spec, encoding="utf-8") as f:
            raw = f.read()
    else:
        raw = os.environ.get("PLX_BUILTIN_SPEC")
        if not raw:
            print("partition plan: no spec (--spec PATH or PLX_BUILTIN_SPEC)",
                  file=sys.stderr)
            return 2
    try:
        plan = plan_for_builtin_spec(json.loads(raw), num_devices=args.num_devices,
                                     num_slices=args.num_slices)
    except (RuleSyntaxError, KeyError, ValueError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(json.dumps(plan, indent=2) if args.as_json else format_plan(plan))
    return 0


def main(argv: list[str]) -> int:
    if argv[:1] == ["plan"]:
        return plan_main(argv[1:])
    from . import audit
    from .rules import UnmatchedParamError

    try:
        report = audit(argv or None)
    except (UnmatchedParamError, AssertionError, KeyError) as e:
        print(f"partition audit FAILED: {e}", file=sys.stderr)
        return 1
    for name, row in report.items():
        print(f"  {name:<16} {row['params']:>3} tensors  "
              f"{row['rules']:>2} rules  {row['status']}")
    print(f"partition audit OK: {len(report)} models, full rule coverage, "
          f"Task-spec parity")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
