"""Parameter paths of the port — ``path_str`` and ``tree_paths`` of
``polyaxon_tpu/partition/rules.py``.

A leaf's path is its keys joined by ``/`` (``layers/attn/wq``), in the
order the JAX package flattens a tree: dict keys sorted, list and tuple
entries by index. Checkpoints and imports key leaves by these paths. The
user partition rules of that module wait for ROADMAP A14.
"""

from __future__ import annotations

from typing import Any, Sequence

PATH_SEP = "/"


def path_str(path: Sequence[Any]) -> str:
    """A key path -> the canonical /-joined name."""
    return PATH_SEP.join(str(k) for k in path)


def _walk(tree: Any, prefix: tuple, out: list) -> None:
    if isinstance(tree, dict):
        for key in sorted(tree):
            _walk(tree[key], prefix + (key,), out)
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            _walk(value, prefix + (i,), out)
    elif tree is not None:  # None is an empty subtree, as in JAX
        out.append((path_str(prefix), tree))


def tree_paths(tree: Any) -> list[tuple[str, Any]]:
    """Flatten nested dicts, lists and tuples into ``[(path_str, leaf),
    ...]`` in tree order."""
    out: list = []
    _walk(tree, (), out)
    return out
