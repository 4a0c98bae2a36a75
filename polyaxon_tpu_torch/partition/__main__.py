"""Rule-coverage audit: ``python -m polyaxon_tpu_torch.partition [models...]``.

Exit 0 iff every zoo model's (or each named model's) full param tree is
matched by its shipped rule set AND the engine's specs equal the port's
``Task.param_specs`` — so a model edit cannot silently fall back to
replicated. Shape math only: no device is touched."""

from __future__ import annotations

import sys


def main(argv: list[str]) -> int:
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
