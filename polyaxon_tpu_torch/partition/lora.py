"""LoRA adapters of the port — counterpart of
``polyaxon_tpu/partition/lora.py``.

A ``lora:`` spec block (``{rank, alpha, target}``) adds low-rank adapter
pairs next to a frozen base tree: ``params = {"base": ..., "lora": ...}``
where each targeted weight ``w`` (selected by the ``target`` regex over the
same /-joined paths the partition rules match) gets ``a: [L?, fan_in, r]``
(f32, a truncated normal at ±2σ times ``init_scale``) and ``b: [L?, r,
fan_out]`` (zero), with the effective weight ``w + (alpha/rank) * (a @
b).reshape(w.shape)``. ``b`` starts at zero, so step 0 is exactly the base
model. How a weight's dims split into fan-in and fan-out is the JAX
package's table, shape for shape (an expert stack ``[L, E, h, mlp]``
under ``mlp/(wi|wg)$`` factors as fan-in E and fan-out h·mlp).

Only the adapters train: :class:`FrozenBaseOptimizer` wraps any port
optimizer; the trainer hands it the adapter leaves alone (their moments,
their own global norm for the clip) and leaves the base untouched. The
reported ``grad_norm`` still covers base and adapters, as the JAX trainer's
``optax.global_norm(grads)`` does.

:class:`LoRATask` reads its base through a merging view
(:class:`~..parallel.fsdp.ShardedTree` with ``merge``): a leaf is gathered
first (fsdp, gathered experts), then its :class:`Adapter` adds the delta of
the block the rank holds — under ``model`` a column block (``wq/wk/wv``,
``mlp/wi|wg``, ``lm_head``: a slice of ``b``'s fan-out) or a row block
(``wo``, ``mlp/wo``: a slice of ``a``'s fan-in), under all-to-all experts
an expert block (a slice of the E dim). Each rank's adapter grad is then a
partial sum, which the trainer sums over that axis.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, Optional

import torch

from ..parallel.blocks import Law, init_tree, keyed
from ..parallel.mesh import PartitionSpec as P
from ..parallel.mesh import sharded_dim
from ..train.tasks import Task
from .rules import map_with_path, nearest_paths, tree_paths

DEFAULT_TARGET = r"attn/(wq|wk|wv|wo)$"

# How a matched weight's dims split into (fan_in, fan_out), AFTER an
# optional leading stacked layers dim: n_in trailing-side split point.
# Table-driven (not "last dim is out") because attention weights keep their
# einsum layouts: wq is [L, in=h, out=(heads, hd)], wo is [L, in=(heads,
# hd), out=h].
_SPLIT_TABLE: tuple[tuple[str, int], ...] = (
    (r"attn/w[qkv]$", 1),
    (r"attn/wo$", 2),
    (r"mlp/(wi|wg)$", 1),
    (r"mlp/wo$", 1),
    (r"(lm_head|head)/w$", 1),
)
_LEAD_RX = re.compile(r"(^|/)layers/")
#: the axes whose cut of a base leaf the layer body reads as a block (fsdp
#: is gathered before use)
_BLOCK_AXES = ("model", "expert", "stage")


class LoRATargetError(ValueError):
    """The ``target`` regex selects a weight LoRA cannot factor (no
    fan-in/fan-out split is defined for it) or selects nothing."""


@dataclass(frozen=True)
class LoRAConfig:
    rank: int = 8
    alpha: float = 16.0
    target: str = DEFAULT_TARGET
    init_scale: float = 0.02  # stddev of the `a` init; `b` starts at zero

    @classmethod
    def from_spec(cls, spec: Any) -> "LoRAConfig":
        if spec is True:
            return cls()
        if not isinstance(spec, dict):
            raise LoRATargetError(
                f"lora spec must be a mapping (rank/alpha/target), got "
                f"{spec!r}")
        return cls(
            rank=int(spec.get("rank", 8)),
            alpha=float(spec.get("alpha", 16.0)),
            target=str(spec.get("target", DEFAULT_TARGET)),
            init_scale=float(spec.get("init_scale", 0.02)),
        )

    @property
    def scaling(self) -> float:
        return self.alpha / max(self.rank, 1)


def _split_point(path: str) -> Optional[int]:
    for pattern, n_in in _SPLIT_TABLE:
        if re.search(pattern, path):
            return n_in
    return None


def target_paths(base_tree: Any, cfg: LoRAConfig) -> list[tuple[str, int, int]]:
    """``[(path, lead, n_in)]`` for every base leaf the target regex
    selects. Raises when the regex matches nothing (with the nearest
    paths) or matches a weight with no known factorization."""
    try:
        rx = re.compile(cfg.target)
    except re.error as e:
        raise LoRATargetError(
            f"lora target regex {cfg.target!r} does not compile: {e}") from e
    out: list[tuple[str, int, int]] = []
    unsupported: list[str] = []
    for path, leaf in tree_paths(base_tree):
        if not rx.search(path):
            continue
        n_in = _split_point(path)
        if n_in is None:
            unsupported.append(path)
            continue
        lead = 1 if _LEAD_RX.search(path) else 0
        if len(leaf.shape) <= lead + n_in:
            unsupported.append(path)
            continue
        out.append((path, lead, n_in))
    if unsupported:
        raise LoRATargetError(
            f"lora target {cfg.target!r} selects weight(s) with no known "
            f"fan-in/fan-out factorization: {unsupported}")
    if not out:
        paths = [p for p, _ in tree_paths(base_tree)]
        raise LoRATargetError(
            f"lora target {cfg.target!r} matches no parameter; nearest "
            f"param paths: {nearest_paths(cfg.target, paths)}")
    return out


def _fan_shapes(shape: tuple, lead: int, n_in: int,
                rank: int) -> tuple[tuple, tuple]:
    lead_dims = tuple(shape[:lead])
    fan_in = math.prod(shape[lead:lead + n_in])
    fan_out = math.prod(shape[lead + n_in:])
    return lead_dims + (fan_in, rank), lead_dims + (rank, fan_out)


def _set_path(tree: dict, path: str, value: Any) -> None:
    parts = path.split("/")
    node = tree
    for part in parts[:-1]:
        node = node.setdefault(part, {})
    node[parts[-1]] = value


def _get_path(tree: Any, path: str) -> Any:
    node = tree
    for part in path.split("/"):
        node = node[part]
    return node


def lora_laws(base_tree: Any, cfg: LoRAConfig, dtype: torch.dtype = torch.float32) -> dict:
    """The adapters' init laws (``parallel/blocks.py``), keyed by their
    paths under ``lora/``: ``a`` a standard normal truncated at ±2 times
    ``init_scale`` (a stacked pair's slices are its layers), ``b`` zero.
    ``base_tree``: the base leaves (their shapes; ``meta`` tensors will
    do)."""
    out: dict = {}
    for path, lead, n_in in target_paths(base_tree, cfg):
        shape = tuple(_get_path(base_tree, path).shape)
        a_shape, b_shape = _fan_shapes(shape, lead, n_in, cfg.rank)
        _set_path(out, path, {
            "a": Law(a_shape, "trunc_normal", cfg.init_scale, lead, dtype),
            "b": Law(b_shape, "zeros", lead=lead, dtype=dtype),
        })
    return keyed(out, "lora/")


def init_lora(base_tree: Any, cfg: LoRAConfig, *, seed: int = 0,
              device: Any = None, dtype: torch.dtype = torch.float32) -> dict:
    """Adapter tree mirroring the targeted base leaves: for base path
    ``layers/attn/wq`` the adapters live at ``layers/attn/wq/a`` and
    ``.../b`` (under the task's ``lora`` branch, so the full param paths
    are ``lora/layers/attn/wq/a`` — matched by ``builtins.LORA_RULES``), by
    :func:`lora_laws` with ``seed``: the ``lora`` subtree of a
    :class:`LoRATask`'s init at that seed. ``device``: the base leaves' by
    default (``meta``: shapes only)."""
    if device is None:
        device = _get_path(base_tree, target_paths(base_tree, cfg)[0][0]).device
    return init_tree(lora_laws(base_tree, cfg, dtype), seed, device)


def _delta(a: torch.Tensor, b: torch.Tensor, shape: tuple, scaling: float) -> torch.Tensor:
    """``(scaling * a @ b).reshape(shape)``: the ``lir,lro->lio``
    contraction for a stacked pair (a batched product over L)."""
    return (torch.matmul(a, b) * scaling).reshape(shape)


def merge_lora(base: Any, lora: dict, cfg: LoRAConfig) -> Any:
    """Functionally apply the adapter deltas onto the base tree (the base
    is never mutated): ``w + (scaling * a @ b).reshape(w.shape)`` in
    ``w``'s dtype at each targeted leaf."""
    flat = dict(tree_paths(lora))
    adapters = {p.rsplit("/", 1)[0] for p in flat}

    def merge(path, w):
        if path not in adapters:
            return w
        a, b = flat[path + "/a"], flat[path + "/b"]
        return w + _delta(a, b, w.shape, cfg.scaling).to(w.dtype)

    return map_with_path(merge, base)


class Adapter:
    """One targeted leaf's pair, merged into the leaf where the layer body
    reads it. ``shape`` is the whole leaf's, ``spec`` its PartitionSpec's
    entries; when the leaf read is a block of it (a dim cut over ``model``
    or ``expert`` that the trainer does not gather), the block's delta comes
    from slices of ``a``'s fan-in or ``b``'s fan-out at this rank's
    coordinate (``coords``)."""

    def __init__(self, a: torch.Tensor, b: torch.Tensor, shape: tuple, lead: int,
                 n_in: int, scaling: float, spec: tuple = (),
                 coords: Optional[dict] = None):
        self.a, self.b, self.shape = a, b, tuple(shape)
        self.lead, self.n_in, self.scaling = lead, n_in, scaling
        self.spec = tuple(spec) + (None,) * (len(self.shape) - len(spec))
        self.coords = coords

    def unstack(self, n: int) -> list:
        """The adapters of the ``n`` layers of a stacked leaf."""
        return [Adapter(a, b, self.shape[1:], self.lead - 1, self.n_in, self.scaling,
                        self.spec[1:], self.coords)
                for a, b in zip(torch.unbind(self.a, 0), torch.unbind(self.b, 0))]

    def _offset(self, d: int, block: int) -> int:
        entry = self.spec[d]
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        cut = [ax for ax in axes if ax in _BLOCK_AXES]
        if len(cut) != 1 or self.coords is None:
            raise ValueError(f"a block of {block} of dim {d} of a {self.shape} leaf under "
                             f"the spec {self.spec}: no single block axis cuts it")
        return self.coords[cut[0]] * block

    def apply(self, w: torch.Tensor) -> torch.Tensor:
        lead, n_in, r = self.lead, self.n_in, self.a.shape[-1]
        full = self.shape
        a = self.a.reshape(full[:lead + n_in] + (r,))
        b = self.b.reshape(full[:lead] + (r,) + full[lead + n_in:])
        for d, (size, whole) in enumerate(zip(w.shape, full)):
            if size == whole:
                continue
            off = self._offset(d, size)
            if d < lead:
                a, b = a.narrow(d, off, size), b.narrow(d, off, size)
            elif d < lead + n_in:
                a = a.narrow(d, off, size)
            else:
                b = b.narrow(d + 1 - n_in, off, size)
        a = a.reshape(a.shape[:lead] + (-1, r))
        b = b.reshape(b.shape[:lead + 1] + (-1,))
        return w + _delta(a, b, w.shape, self.scaling).to(w.dtype)


def adapter_tree(lora: Any, base_abstract: Any, specs: Any, cfg: LoRAConfig,
                 coords: Optional[dict] = None) -> dict:
    """The ``merge`` tree of a base view: an :class:`Adapter` at each
    targeted leaf (``lora``: the adapter tree, read through a view when
    it is one; ``base_abstract``: the whole leaves' shapes; ``specs``: the
    base's PartitionSpecs)."""
    out: dict = {}
    for path, lead, n_in in target_paths(base_abstract, cfg):
        node = lora
        for part in path.split("/"):
            node = node[part]
        _set_path(out, path, Adapter(node["a"], node["b"], _get_path(base_abstract, path).shape,
                                     lead, n_in, cfg.scaling, tuple(_get_path(specs, path)),
                                     coords))
    return out


class FrozenBaseOptimizer:
    """Train only the ``lora`` subtree, the counterpart of JAX's
    ``frozen_base_optimizer``: :meth:`trains` names the leaves the inner
    optimizer sees. The trainer gives it those leaves alone — their
    moments are its state, their own global norm its clip's — and leaves
    the base leaves as they are (no update, not even a zero: a −0.0 stays
    −0.0)."""

    def __init__(self, inner: Any):
        self.inner = inner
        self.cfg = inner.cfg

    @staticmethod
    def trains(path: str) -> bool:
        return path.split("/", 1)[0] == "lora"

    def init(self, params: list):
        return self.inner.init(params)

    def layout(self, shapes: list, cuts: list, mesh) -> None:
        self.inner.layout(shapes, cuts, mesh)

    def update(self, grads: list, state, params: list,
               g_norm: Optional[torch.Tensor] = None):
        return self.inner.update(grads, state, params, g_norm)


class LoRATask(Task):
    """Wrap a transformer-family Task (LM or MLM): params become ``{"base",
    "lora"}``, the loss runs the inner task on the merged weights (a view
    that adds each layer's delta after its gather), the base takes the
    inner task's specs and the adapters ``P()``. ``tokens_per_step`` and
    ``flops_per_token`` are the inner task's, so MFU keeps the full
    model's FLOPs."""

    def __init__(self, inner: Any, cfg: LoRAConfig):
        self.inner = inner
        self.cfg = cfg
        self.default_data_kind = inner.default_data_kind
        self._base_specs = None
        self._abstract = None

    def _base_abstract(self) -> dict:
        if self._abstract is None:
            self._abstract = self.inner.abstract_params()
        return self._abstract

    def param_laws(self) -> dict:
        # the base keeps the inner task's keys: at one seed its init is the
        # plain model's
        return {"base": self.inner.param_laws(),
                "lora": lora_laws(self._base_abstract(), self.cfg)}

    def extra_laws(self):
        return self.inner.extra_laws()

    def param_specs(self, rules) -> dict:
        self._base_specs = self.inner.param_specs(rules)
        lora = init_lora(self._base_abstract(), self.cfg, device="meta")
        return {"base": self._base_specs,
                "lora": map_with_path(lambda _p, _leaf: P(), lora)}

    def extra_specs(self, rules):
        return self.inner.extra_specs(rules)

    def loss(self, params, extra, batch, mesh=None):
        from ..parallel.fsdp import ShardedTree

        base = params["base"]
        if self._base_specs is None:
            from ..parallel.mesh import ShardingRules

            self._base_specs = self.inner.param_specs(ShardingRules())
        coords = mesh.coords() if mesh is not None else None
        merge = adapter_tree(params["lora"], self._base_abstract(), self._base_specs,
                             self.cfg, coords)
        if isinstance(base, ShardedTree):
            view = base.with_merge(merge)
        else:
            view = ShardedTree(base, map_with_path(lambda _p, _leaf: (), base), None, merge)
        return self.inner.loss(view, extra, batch, mesh=mesh)

    def partial_sum_axes(self, mesh) -> dict:
        """``{param path: axes}`` over which an adapter's grad is a partial
        sum besides the token axes: ``model`` for the adapters of a leaf the
        model axis cuts, each rank of which computes its block's delta."""
        if mesh is None or not mesh.tp:
            return {}
        out = {}
        for path, _, _ in target_paths(self._base_abstract(), self.cfg):
            if sharded_dim(_get_path(self._base_specs, path), "model") is not None:
                out[f"lora/{path}/a"] = out[f"lora/{path}/b"] = ("model",)
        return out

    def tokens_per_step(self, batch_size, seq_len):
        return self.inner.tokens_per_step(batch_size, seq_len)

    def flops_per_token(self, seq_len):
        return self.inner.flops_per_token(seq_len)
