"""Keeps JAX and the JAX package out of a run.

Module names are compared by their top-level name, whole: the port
``polyaxon_tpu_torch`` begins with the JAX package's name
``polyaxon_tpu`` and is allowed; ``polyaxon_tpu`` and its submodules are
not.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "polyaxon_tpu"})
PROGRAM = "polyaxon_tpu_torch"


def top(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_forbidden(modules=None) -> list[str]:
    """The forbidden modules in ``sys.modules`` (or ``modules``)."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if top(n) in FORBIDDEN)


def imported_tops(path: Path) -> set[str]:
    """The top-level names a source file imports (absolute imports)."""
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(top(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(top(node.module))
    return out
