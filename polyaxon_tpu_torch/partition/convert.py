"""Foreign-checkpoint import and export of the port — counterpart of
``polyaxon_tpu/partition/convert.py``: import never materializes the model
unsharded on one rank.

A foreign checkpoint is a flat ``name -> array`` mapping in some container
(a directory of ``.npy`` files, one ``.npz``, or a ``.safetensors`` file)
and some *layout* (the native flat paths, or HF-style llama keys). Sources
hand out CPU tensors backed by a memory map where the container allows
(``.npy`` and ``.safetensors``). Import reads each leaf's block of this
rank (``placement``: the trainer's layout, user rules included, as the JAX
package takes ``shardings=``): a direct leaf reads only the block's part
of the mapped source, a stacked HF leaf only the block's layers, one at a
time, each transformed and then cut. An ``.npz`` cannot be sliced without
reading an array whole: it reads one leaf at a time and keeps the block,
as the JAX package's npz source does.

Layouts:

- ``flat``: source keys are the native /-joined param paths; optional
  ``key_map`` (regex -> replacement rename) and ``transpose`` (regex ->
  axis permutation) adapt near-native trees.
- ``hf-llama``: HuggingFace ``LlamaForCausalLM`` state-dict keys and
  matrix layouts (fused ``[out, in]`` projections, per-layer weights),
  mapped onto the scan-stacked ``[L, ...]`` einsum-layout tree.

bfloat16: numpy has no type of its own for it. A ``.npy`` written from a
bf16 array holds 2-byte void records (``<V2``, as ``ml_dtypes`` writes
them); these read back as bf16. ``.safetensors`` is parsed by hand (an
8-byte little-endian header length, a JSON header, raw bytes), so ``BF16``
needs no extra package either.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from ..models.transformer import TransformerConfig, abstract_params, flatten, unflatten
from ..parallel.blocks import Placement
from .rules import tree_paths


class ImportError_(ValueError):
    """A checkpoint import cannot proceed: missing source keys, layout
    mismatch, or shape disagreement. Lists every problem at once."""


def _tensor(arr: np.ndarray) -> torch.Tensor:
    """numpy -> CPU tensor sharing its memory; 2-byte void records are
    bfloat16."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


# ---------------------------------------------------------------------------
# Containers: name -> lazy tensor
# ---------------------------------------------------------------------------


class NpyDirSource:
    """Directory tree of ``.npy`` files; key = relative path without the
    extension (``/`` in native paths becomes real directories, HF dotted
    keys are plain file names). Arrays open memory-mapped (copy on write,
    so the file is never written)."""

    def __init__(self, path: str):
        self.path = path
        self._keys: dict[str, str] = {}
        for root, _, files in os.walk(path):
            for f in files:
                if f.endswith(".npy"):
                    full = os.path.join(root, f)
                    rel = os.path.relpath(full, path)[: -len(".npy")]
                    self._keys[rel.replace(os.sep, "/")] = full

    def keys(self) -> list[str]:
        return sorted(self._keys)

    def get(self, name: str) -> torch.Tensor:
        return _tensor(np.load(self._keys[name], mmap_mode="c"))


class NpzSource:
    """One ``.npz``: each array loads whole on first access (fine for
    per-layer HF weights; the npy-dir container is the one for giant
    stacked native trees)."""

    def __init__(self, path: str):
        self.path = path
        self._z = np.load(path)

    def keys(self) -> list[str]:
        return sorted(self._z.files)

    def get(self, name: str) -> torch.Tensor:
        return _tensor(self._z[name])


_ST_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "BF16": np.int16, "I64": np.int64, "I32": np.int32, "I16": np.int16,
    "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_,
}


class SafetensorsSource:
    """``.safetensors`` read by hand: an 8-byte little-endian header
    length, a JSON header of ``{name: {dtype, shape, data_offsets}}``,
    then the raw little-endian bytes, which are memory-mapped. ``BF16`` is
    read as 16-bit integers reinterpreted as ``torch.bfloat16``."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            head = f.read(8)
            if len(head) != 8:
                raise ImportError_(f"{path!r} is too short for a safetensors file")
            n = int.from_bytes(head, "little")
            try:
                header = json.loads(f.read(n))
            except ValueError as e:
                raise ImportError_(f"{path!r}: unreadable safetensors header") from e
        header.pop("__metadata__", None)
        self._base = 8 + n
        self._header = header
        size = os.path.getsize(path)
        for name, info in header.items():
            if info["dtype"] not in _ST_DTYPES:
                raise ImportError_(f"{name}: safetensors dtype {info['dtype']!r} is not "
                                   f"supported; valid: {sorted(_ST_DTYPES)}")
            if self._base + info["data_offsets"][1] > size:
                raise ImportError_(f"{name}: data past the end of {path!r} (truncated?)")
        self._map = (np.memmap(path, dtype=np.uint8, mode="c")
                     if size > self._base else np.zeros(0, np.uint8))

    def keys(self) -> list[str]:
        return sorted(self._header)

    def get(self, name: str) -> torch.Tensor:
        info = self._header[name]
        begin, end = info["data_offsets"]
        dt = np.dtype(_ST_DTYPES[info["dtype"]]).newbyteorder("<")
        shape = tuple(info["shape"])
        if end - begin != int(np.prod(shape, dtype=np.int64)) * dt.itemsize:
            raise ImportError_(f"{name}: {end - begin} bytes for shape {shape} "
                               f"{info['dtype']}")
        raw = self._map[self._base + begin:self._base + end]
        t = torch.from_numpy(raw.view(dt).reshape(shape))
        return t.view(torch.bfloat16) if info["dtype"] == "BF16" else t


def open_source(path: str) -> Any:
    if os.path.isdir(path):
        return NpyDirSource(path)
    if path.endswith(".npz"):
        return NpzSource(path)
    if path.endswith(".safetensors"):
        return SafetensorsSource(path)
    raise ImportError_(
        f"cannot open checkpoint source {path!r}: expected a directory of "
        f".npy files, an .npz, or a .safetensors file")


# ---------------------------------------------------------------------------
# Readers: target path -> a tensor on the device
# ---------------------------------------------------------------------------


def _expand_idx(idx: Any, ndim: int) -> tuple:
    if not isinstance(idx, tuple):
        idx = (idx,)
    return tuple(idx) + (slice(None),) * (ndim - len(idx))


def _block_shape(idx: tuple, shape: tuple) -> tuple:
    return tuple(len(range(*i.indices(n))) for i, n in zip(idx, shape))


class DirectReader:
    """Target == one source array, optionally permuted (a view on the
    mapped containers, so the block is the only data read)."""

    def __init__(self, source: Any, key: str, shape: tuple,
                 transpose: Optional[Sequence[int]] = None):
        self.source, self.key, self.shape = source, key, tuple(shape)
        self.transpose = tuple(transpose) if transpose is not None else None

    def read(self, idx: Any, dtype: torch.dtype, device) -> torch.Tensor:
        """The block ``idx`` (slices per dim) of the target on ``device``."""
        t = self.source.get(self.key)
        if self.transpose is not None:
            t = t.permute(self.transpose)
        if tuple(t.shape) != self.shape:
            raise ImportError_(
                f"source key {self.key!r} has shape {tuple(t.shape)}, "
                f"target wants {self.shape}")
        part = t[_expand_idx(idx, len(self.shape))]
        return torch.empty(part.shape, dtype=dtype, device=device).copy_(part)


class StackedReader:
    """Target dim 0 stacks per-layer source arrays (the HF -> scan-stacked
    mapping): the block's layers are read one at a time, each transformed
    (transpose/reshape: a view, or one layer's copy), cut to the block and
    copied into its slot on the device, so the host holds one layer at a
    time and never the stack."""

    def __init__(self, per_layer: Sequence[Callable[[], torch.Tensor]],
                 shape: tuple):
        self.per_layer = list(per_layer)
        self.shape = tuple(shape)

    def read(self, idx: Any, dtype: torch.dtype, device) -> torch.Tensor:
        idx = _expand_idx(idx, len(self.shape))
        out = torch.empty(_block_shape(idx, self.shape), dtype=dtype, device=device)
        for j, i in enumerate(range(*idx[0].indices(self.shape[0]))):
            out[j].copy_(self.per_layer[i]()[idx[1:]])
        return out


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------


def target_shapes(cfg: TransformerConfig) -> dict[str, tuple]:
    """/-joined param path -> shape, for every leaf of the model's tree."""
    return {"/".join(path): tuple(leaf[0]) for path, leaf in flatten(abstract_params(cfg))}


def flat_entries(
    source: Any,
    shapes: dict[str, tuple],
    *,
    key_map: Optional[Sequence[tuple[str, str]]] = None,
    transpose: Optional[Sequence[tuple[str, Sequence[int]]]] = None,
) -> dict[str, Any]:
    """Native flat layout: target path -> source key via optional regex
    renames, with optional per-key transposes."""
    key_rules = [(re.compile(p), r) for p, r in (key_map or [])]
    t_rules = [(re.compile(p), tuple(ax)) for p, ax in (transpose or [])]
    available = set(source.keys())
    entries: dict[str, Any] = {}
    missing: list[str] = []
    for path, shape in shapes.items():
        key = path
        for rx, repl in key_rules:
            if rx.search(key):
                key = rx.sub(repl, key)
                break
        if key not in available:
            missing.append(f"{path} (source key {key!r})")
            continue
        axes = None
        for rx, perm in t_rules:
            if rx.search(path):
                axes = perm
                break
        entries[path] = DirectReader(source, key, shape, transpose=axes)
    if missing:
        raise ImportError_(
            f"{len(missing)} parameter(s) have no source key:\n"
            + "\n".join(f"  - {m}" for m in missing)
            + f"\n(source has {len(available)} keys)")
    return entries


def _hf_llama_check(cfg: Any) -> None:
    problems = []
    if cfg.norm != "rms":
        problems.append(f"norm={cfg.norm!r} (HF llama uses rms)")
    if cfg.act != "swiglu":
        problems.append(f"act={cfg.act!r} (HF llama uses swiglu)")
    if cfg.pos != "rope":
        problems.append(f"pos={cfg.pos!r} (HF llama uses rope)")
    if cfg.use_bias:
        problems.append("use_bias=True (HF llama has no biases)")
    if cfg.tie_embeddings:
        problems.append("tie_embeddings=True (HF llama has a separate lm_head)")
    if getattr(cfg, "num_experts", 0):
        problems.append("num_experts>0 (use the flat layout for MoE trees)")
    if problems:
        raise ImportError_(
            "model config is not HF-llama-shaped: " + "; ".join(problems))


def hf_llama_entries(source: Any, cfg: Any, shapes: dict[str, tuple]) -> dict[str, Any]:
    """HF ``LlamaForCausalLM`` layout -> the port's tree.

    HF stores per-layer fused ``[out_features, in_features]`` projection
    matrices under ``model.layers.{i}.*``; ours are scan-stacked einsum
    layouts (``wq: [L, h, nh, hd]`` etc.). RoPE convention: the runtime
    rotates half-dim pairs the same way HF's ``rotate_half`` does, so q/k
    need no head-interleave permutation — layout transforms only.
    """
    _hf_llama_check(cfg)
    h, nh, kvh, hd = cfg.hidden, cfg.num_heads, cfg.kv_heads, cfg.hd
    L, m = cfg.num_layers, cfg.mlp_dim
    available = set(source.keys())

    def layer_reader(fmt: str, transform: Callable[[torch.Tensor], torch.Tensor],
                     shape: tuple) -> StackedReader:
        return StackedReader(
            [(lambda i=i: transform(source.get(fmt.format(i=i))))
             for i in range(L)],
            (L,) + tuple(shape))

    entries: dict[str, Any] = {
        "embed/tokens": DirectReader(
            source, "model.embed_tokens.weight", (cfg.vocab_size, h)),
        "lm_head/w": DirectReader(
            source, "lm_head.weight", (h, cfg.vocab_size), transpose=(1, 0)),
        "final_norm/scale": DirectReader(source, "model.norm.weight", (h,)),
        "layers/attn_norm/scale": layer_reader(
            "model.layers.{i}.input_layernorm.weight", lambda a: a, (h,)),
        "layers/mlp_norm/scale": layer_reader(
            "model.layers.{i}.post_attention_layernorm.weight",
            lambda a: a, (h,)),
        "layers/attn/wq": layer_reader(
            "model.layers.{i}.self_attn.q_proj.weight",
            lambda a: a.T.reshape(h, nh, hd), (h, nh, hd)),
        "layers/attn/wk": layer_reader(
            "model.layers.{i}.self_attn.k_proj.weight",
            lambda a: a.T.reshape(h, kvh, hd), (h, kvh, hd)),
        "layers/attn/wv": layer_reader(
            "model.layers.{i}.self_attn.v_proj.weight",
            lambda a: a.T.reshape(h, kvh, hd), (h, kvh, hd)),
        "layers/attn/wo": layer_reader(
            "model.layers.{i}.self_attn.o_proj.weight",
            lambda a: a.T.reshape(nh, hd, h), (nh, hd, h)),
        "layers/mlp/wi": layer_reader(
            "model.layers.{i}.mlp.up_proj.weight", lambda a: a.T, (h, m)),
        "layers/mlp/wg": layer_reader(
            "model.layers.{i}.mlp.gate_proj.weight", lambda a: a.T, (h, m)),
        "layers/mlp/wo": layer_reader(
            "model.layers.{i}.mlp.down_proj.weight", lambda a: a.T, (m, h)),
    }
    target_paths = set(shapes)
    if target_paths != set(entries):
        extra = sorted(set(entries) - target_paths)
        miss = sorted(target_paths - set(entries))
        raise ImportError_(
            f"hf-llama layout does not cover this tree (missing {miss}, "
            f"unexpected {extra})")
    needed = {"model.embed_tokens.weight", "lm_head.weight",
              "model.norm.weight"}
    for i in range(L):
        for k in ("input_layernorm.weight", "post_attention_layernorm.weight",
                  "self_attn.q_proj.weight", "self_attn.k_proj.weight",
                  "self_attn.v_proj.weight", "self_attn.o_proj.weight",
                  "mlp.up_proj.weight", "mlp.gate_proj.weight",
                  "mlp.down_proj.weight"):
            needed.add(f"model.layers.{i}.{k}")
    missing = sorted(needed - available)
    if missing:
        raise ImportError_(
            f"{len(missing)} HF llama key(s) missing from the source "
            f"(first few): {missing[:8]}")
    return entries


def detect_layout(source: Any) -> str:
    keys = source.keys()
    if any(k.startswith("model.embed_tokens") for k in keys):
        return "hf-llama"
    return "flat"


# ---------------------------------------------------------------------------
# Import / export
# ---------------------------------------------------------------------------


def _torch_dtype(dtype: Any) -> torch.dtype:
    dt = dtype if isinstance(dtype, torch.dtype) else getattr(torch, str(dtype), None)
    if not isinstance(dt, torch.dtype):
        raise ImportError_(f"unknown dtype {dtype!r}")
    return dt


def import_params(
    source: Any,
    cfg: Any,
    *,
    device: Any,
    layout: str = "auto",
    dtype: Optional[Any] = None,
    key_map: Optional[Sequence[tuple[str, str]]] = None,
    transpose: Optional[Sequence[tuple[str, Sequence[int]]]] = None,
    placement: Optional[Placement] = None,
) -> dict:
    """Read a foreign param source into the model's param tree on
    ``device``, leaf by leaf: each leaf this rank's block of it under
    ``placement`` (the trainer's layout; None: the whole leaf). Leaves take
    ``cfg.param_dtype``, or ``dtype`` (e.g. ``"bfloat16"`` for a serving
    import of an f32 export) when given."""
    if isinstance(source, str):
        source = open_source(source)
    if not isinstance(cfg, TransformerConfig):
        raise ImportError_(
            f"import targets transformer-family models; got "
            f"{type(cfg).__name__}")
    shapes = target_shapes(cfg)
    if layout == "auto":
        layout = detect_layout(source)
    if layout == "hf-llama":
        entries = hf_llama_entries(source, cfg, shapes)
    elif layout == "flat":
        entries = flat_entries(source, shapes, key_map=key_map,
                               transpose=transpose)
    else:
        raise ImportError_(
            f"unknown import layout {layout!r}; valid: flat | hf-llama")
    dt = _torch_dtype(dtype) if dtype is not None else cfg.param_dtype
    device = torch.device(device)
    place = placement if placement is not None else Placement()
    return unflatten([tuple(p.split("/")) for p in shapes],
                     [entries[p].read(place.index(p, shapes[p]), dt, device) for p in shapes])


def _to_numpy(x: Any) -> np.ndarray:
    """One leaf on the host; bf16 as 2-byte void records (the ``.npy``
    form ``ml_dtypes`` writes)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(x)


def save_flat(tree_or_dict: Any, path: str) -> list[str]:
    """Write a param tree (or flat name->array dict) as an npy-dir
    container, one leaf on the host at a time. Native '/'-joined paths
    become subdirectories; HF dotted keys are plain filenames. Returns the
    keys written."""
    if isinstance(tree_or_dict, dict) and all(
            not isinstance(v, dict) for v in tree_or_dict.values()):
        flat = dict(tree_or_dict)
    else:
        flat = dict(tree_paths(tree_or_dict))
    written = []
    for key, arr in flat.items():
        full = os.path.join(path, *key.split("/")) + ".npy"
        os.makedirs(os.path.dirname(full), exist_ok=True)
        np.save(full, _to_numpy(arr))
        written.append(key)
    return sorted(written)


def export_hf_llama(params: dict, cfg: Any, path: str) -> list[str]:
    """Inverse of the hf-llama import mapping: write the port's param tree
    as an HF ``LlamaForCausalLM``-layout npy-dir (per-layer fused
    ``[out, in]`` matrices, HF key names). The per-layer matrices are
    views of the device tensors; each reaches the host alone as it is
    written."""
    _hf_llama_check(cfg)
    h, nh, kvh, hd = cfg.hidden, cfg.num_heads, cfg.kv_heads, cfg.hd
    L = cfg.num_layers
    p = params
    out: dict[str, Any] = {
        "model.embed_tokens.weight": p["embed"]["tokens"],
        "lm_head.weight": p["lm_head"]["w"].T,
        "model.norm.weight": p["final_norm"]["scale"],
    }
    att, mlp = p["layers"]["attn"], p["layers"]["mlp"]
    for i in range(L):
        pre = f"model.layers.{i}."
        out[pre + "input_layernorm.weight"] = p["layers"]["attn_norm"]["scale"][i]
        out[pre + "post_attention_layernorm.weight"] = \
            p["layers"]["mlp_norm"]["scale"][i]
        out[pre + "self_attn.q_proj.weight"] = att["wq"][i].reshape(h, nh * hd).T
        out[pre + "self_attn.k_proj.weight"] = att["wk"][i].reshape(h, kvh * hd).T
        out[pre + "self_attn.v_proj.weight"] = att["wv"][i].reshape(h, kvh * hd).T
        out[pre + "self_attn.o_proj.weight"] = att["wo"][i].reshape(nh * hd, h).T
        out[pre + "mlp.up_proj.weight"] = mlp["wi"][i].T
        out[pre + "mlp.gate_proj.weight"] = mlp["wg"][i].T
        out[pre + "mlp.down_proj.weight"] = mlp["wo"][i].T
    return save_flat(out, path)
