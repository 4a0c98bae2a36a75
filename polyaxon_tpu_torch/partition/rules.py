"""The declarative partition-rule engine of the port — counterpart of
``polyaxon_tpu/partition/rules.py``.

A rule set is ordered ``(regex, PartitionSpec)`` pairs matched against
``/``-joined parameter paths (``layers/attn/wq``). First match wins,
scalars replicate, and an unmatched parameter is a loud
:class:`UnmatchedParamError` listing every unmatched path — never a silent
fall-back to replicated. A leaf's path is its keys joined by ``/``, in the
order the JAX package flattens a tree: dict keys sorted, list and tuple
entries by index. Checkpoints and imports key leaves by these paths too.

Rule sets come from the built-in sets per model family
(:mod:`.builtins`), a ``partition_rules:`` block (:func:`parse_rules`,
overlaid with :func:`overlay_partition_rules`) and the adapters of
:mod:`.lora`. Specs are the port's :class:`~..parallel.mesh.PartitionSpec`
over its ``MESH_AXES``; a leaf is anything with a ``shape`` (a tensor,
a ``meta`` tensor of an abstract tree).
"""

from __future__ import annotations

import difflib
import math
import re
from typing import Any, Callable, Optional, Sequence

from ..parallel.mesh import MESH_AXES, PartitionSpec as P

PATH_SEP = "/"

# How many unmatched paths an UnmatchedParamError message shows before
# truncating (the full list always rides on the exception's .paths).
_MAX_PATHS_SHOWN = 24


class RuleSyntaxError(ValueError):
    """A partition rule itself is malformed: the regex does not compile,
    a spec names an unknown mesh axis, the spec has more entries than the
    matched parameter has dims, or (at validation) the rule matches no
    parameter at all. Carries the offending ``rule`` pattern."""

    def __init__(self, message: str, rule: Optional[str] = None):
        super().__init__(message)
        self.rule = rule


class UnmatchedParamError(ValueError):
    """One or more parameters matched NO rule. ``paths`` carries every
    unmatched ``/``-joined path so the fix is one read, not a bisect."""

    def __init__(self, paths: Sequence[str], rules: Sequence[Any] = ()):
        self.paths = list(paths)
        shown = self.paths[:_MAX_PATHS_SHOWN]
        more = len(self.paths) - len(shown)
        listing = "\n".join(f"  - {p}" for p in shown)
        if more > 0:
            listing += f"\n  ... and {more} more"
        patterns = [r[0] for r in rules]
        super().__init__(
            f"{len(self.paths)} parameter(s) matched no partition rule "
            f"(rules tried, in order: {patterns}):\n{listing}"
        )


def path_str(path: Sequence[Any]) -> str:
    """A key path -> the canonical /-joined name."""
    return PATH_SEP.join(str(k) for k in path)


def is_spec(x: Any) -> bool:
    return isinstance(x, P)


def _walk(tree: Any, prefix: tuple, out: list, is_leaf: Optional[Callable]) -> None:
    if is_leaf is not None and is_leaf(tree):
        out.append((path_str(prefix), tree))
    elif isinstance(tree, dict):
        for key in sorted(tree):
            _walk(tree[key], prefix + (key,), out, is_leaf)
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            _walk(value, prefix + (i,), out, is_leaf)
    elif tree is not None:  # None is an empty subtree, as in JAX
        out.append((path_str(prefix), tree))


def tree_paths(tree: Any, is_leaf: Optional[Callable] = None) -> list[tuple[str, Any]]:
    """Flatten nested dicts, lists and tuples into ``[(path_str, leaf),
    ...]`` in tree order (``is_leaf``: a node to keep whole, e.g. a spec)."""
    out: list = []
    _walk(tree, (), out, is_leaf)
    return out


def map_with_path(fn: Callable, tree: Any, *rest: Any, prefix: str = "") -> Any:
    """``fn(path, leaf, *the same node of each of rest)`` over the nested
    dicts of ``tree``, keeping its structure (the others' nodes are read
    at the same keys; a spec in them is a leaf)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], *(r[k] for r in rest),
                                 prefix=f"{prefix}{k}{PATH_SEP}")
                for k in sorted(tree)}
    return fn(prefix[:-len(PATH_SEP)], tree, *rest)


def _is_scalar(leaf: Any) -> bool:
    shape = getattr(leaf, "shape", None)
    if shape is None:
        return False
    return len(shape) == 0 or math.prod(shape) == 1


def normalize_spec(spec: Any) -> tuple:
    """Canonical form for spec equivalence: each entry a tuple of axis
    names (or None), trailing Nones stripped — so ``P()`` == ``P(None,
    None)`` and ``P("fsdp")`` == ``P(("fsdp",))``."""
    entries: list = []
    for e in tuple(spec):
        if e is None:
            entries.append(None)
        elif isinstance(e, str):
            entries.append((e,))
        else:
            entries.append(tuple(e))
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def specs_equivalent(a: Any, b: Any) -> bool:
    return normalize_spec(a) == normalize_spec(b)


def spec_axes(spec: Any) -> tuple[str, ...]:
    """Every mesh axis a spec shards over, in entry order."""
    out: list[str] = []
    for entry in normalize_spec(spec):
        if entry is not None:
            out.extend(entry)
    return tuple(out)


def _compile_rules(rules: Sequence[tuple[str, Any]]) -> list[tuple[str, Any, P]]:
    compiled = []
    for rule in rules:
        try:
            pattern, spec = rule
        except (TypeError, ValueError) as e:
            raise RuleSyntaxError(
                f"partition rule {rule!r} is not a (regex, spec) pair"
            ) from e
        try:
            rx = re.compile(pattern)
        except re.error as e:
            raise RuleSyntaxError(
                f"partition rule regex {pattern!r} does not compile: {e}",
                rule=pattern,
            ) from e
        compiled.append((pattern, rx, spec))
    return compiled


def _check_rank(pattern: str, spec: P, name: str, leaf: Any) -> None:
    shape = getattr(leaf, "shape", None)
    if shape is not None and len(tuple(spec)) > len(shape):
        raise RuleSyntaxError(
            f"partition rule {pattern!r} carries a {len(tuple(spec))}-entry "
            f"PartitionSpec but matches {name!r} with only {len(shape)} "
            f"dims (shape {tuple(shape)})",
            rule=pattern,
        )


def _first_match(compiled: list, name: str, leaf: Any) -> Optional[P]:
    for pattern, rx, spec in compiled:
        if rx.search(name):
            _check_rank(pattern, spec, name, leaf)
            return spec
    return None


def match_partition_rules(rules: Sequence[tuple[str, Any]], params: Any) -> Any:
    """PartitionSpec tree for ``params`` from an ordered rule set.

    First-match-wins over ``re.search`` on the /-joined path; scalar leaves
    (ndim 0 or one element) replicate without consulting the rules; every
    unmatched path is collected and raised together as
    :class:`UnmatchedParamError`.
    """
    compiled = _compile_rules(rules)
    unmatched: list[str] = []

    def get_spec(name, leaf):
        if _is_scalar(leaf):
            return P()
        spec = _first_match(compiled, name, leaf)
        if spec is None:
            unmatched.append(name)
            return P()
        return spec

    out = map_with_path(get_spec, params)
    if unmatched:
        raise UnmatchedParamError(unmatched, rules=list(rules))
    return out


def overlay_partition_rules(rules: Sequence[tuple[str, Any]], params: Any,
                            base_specs: Any) -> Any:
    """User rules override-or-extend a base spec tree: a leaf whose path
    matches a rule takes the rule's spec, everything else keeps its base
    spec (the built-in set). Scalars stay replicated either way."""
    compiled = _compile_rules(rules)

    def pick(name, leaf, base):
        if _is_scalar(leaf):
            return P()
        spec = _first_match(compiled, name, leaf)
        return base if spec is None else spec

    return map_with_path(pick, params, base_specs)


# ---------------------------------------------------------------------------
# Polyaxonfile (JSON/YAML) rule form
# ---------------------------------------------------------------------------


def _parse_entry(entry: Any, pattern: str) -> Any:
    if entry is None:
        return None
    if isinstance(entry, str):
        if entry not in MESH_AXES:
            raise RuleSyntaxError(
                f"partition rule {pattern!r}: unknown mesh axis {entry!r}; "
                f"valid: {list(MESH_AXES)}",
                rule=pattern,
            )
        return entry
    if isinstance(entry, (list, tuple)):
        axes = [_parse_entry(e, pattern) for e in entry]
        if any(a is None or not isinstance(a, str) for a in axes):
            raise RuleSyntaxError(
                f"partition rule {pattern!r}: a nested spec entry must be "
                f"a list of axis names, got {entry!r}",
                rule=pattern,
            )
        return tuple(axes)
    raise RuleSyntaxError(
        f"partition rule {pattern!r}: spec entry {entry!r} must be null, "
        f"an axis name, or a list of axis names",
        rule=pattern,
    )


def parse_rules(raw: Any) -> tuple[tuple[str, P], ...]:
    """Parse the ``partition_rules:`` block.

    Form: a list of 2-item entries ``[regex, spec]`` where spec is
    ``null``/``"replicated"`` (fully replicated), or a list with one entry
    per dim — each ``null``, a mesh-axis name, or a list of axis names.
    Raises :class:`RuleSyntaxError` (with the offending regex) on every
    malformation.
    """
    if raw is None:
        return ()
    if not isinstance(raw, (list, tuple)):
        raise RuleSyntaxError(
            f"partition_rules must be a list of [regex, spec] pairs, got "
            f"{type(raw).__name__}"
        )
    rules: list[tuple[str, P]] = []
    for item in raw:
        if not isinstance(item, (list, tuple)) or len(item) != 2:
            raise RuleSyntaxError(
                f"partition rule {item!r} is not a [regex, spec] pair")
        pattern, spec_raw = item
        if not isinstance(pattern, str):
            raise RuleSyntaxError(
                f"partition rule pattern {pattern!r} must be a string")
        try:
            re.compile(pattern)
        except re.error as e:
            raise RuleSyntaxError(
                f"partition rule regex {pattern!r} does not compile: {e}",
                rule=pattern,
            ) from e
        if spec_raw is None or spec_raw in ("replicated", "replicate"):
            spec = P()
        elif isinstance(spec_raw, P):
            spec = spec_raw  # already parsed (idempotent re-entry)
        elif isinstance(spec_raw, (list, tuple)):
            spec = P(*[_parse_entry(e, pattern) for e in spec_raw])
        else:
            raise RuleSyntaxError(
                f"partition rule {pattern!r}: spec {spec_raw!r} must be "
                f"null, 'replicated', or a list with one entry per dim",
                rule=pattern,
            )
        rules.append((pattern, spec))
    return tuple(rules)


def rules_to_jsonable(rules: Sequence[tuple[str, Any]]) -> list:
    """Inverse of :func:`parse_rules` (plan output / run outputs)."""
    out = []
    for pattern, spec in rules:
        entries = [list(e) if isinstance(e, (list, tuple)) else e
                   for e in tuple(spec)]
        out.append([pattern, entries or None])
    return out


def nearest_paths(pattern: str, paths: Sequence[str], n: int = 5) -> list[str]:
    """Closest parameter paths to a regex that matched nothing — the
    validation hint for a typo'd rule."""
    # strip regex metacharacters so difflib compares name-ish content
    stripped = re.sub(r"[\^\$\\\.\*\+\?\(\)\[\]\{\}\|]", "", pattern)
    close = difflib.get_close_matches(stripped, paths, n=n, cutoff=0.0)
    return close[:n]


def validate_rules_against(rules: Sequence[tuple[str, Any]],
                           paths_and_leaves: Sequence[tuple[str, Any]], *,
                           require_match: bool = True) -> None:
    """Rule validation against a parameter tree's paths: every rule must
    compile, respect each matched leaf's rank, and — when
    ``require_match`` — match at least one parameter, else the error
    carries the nearest real paths."""
    compiled = _compile_rules(rules)
    paths = [p for p, _ in paths_and_leaves]
    for pattern, rx, spec in compiled:
        hits = 0
        for name, leaf in paths_and_leaves:
            if rx.search(name):
                hits += 1
                _check_rank(pattern, spec, name, leaf)
        if require_match and not hits:
            near = nearest_paths(pattern, paths)
            raise RuleSyntaxError(
                f"partition rule {pattern!r} matches no parameter; nearest "
                f"param paths: {near}",
                rule=pattern,
            )
