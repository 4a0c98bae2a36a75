"""Transformer config, parameter layout and init for the port.

Counterpart of ``polyaxon_tpu/models/transformer.py``, reduced to what the
serving path needs: the config, the parameter tree (the same nested-dict
layout with layer-stacked ``[L, ...]`` leaves, so weights carry across
unchanged), the init law, the norm dispatch and the LM-head lookup.
Parameters are a plain nested dict of tensors; the layer loop lives in
``serve/model.py``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import torch

from ..ops.layers import layer_norm, rms_norm


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int
    hidden: int
    num_layers: int
    num_heads: int
    mlp_dim: int
    num_kv_heads: Optional[int] = None          # GQA; defaults to num_heads
    head_dim: Optional[int] = None              # defaults to hidden // num_heads
    max_seq: int = 2048
    norm: str = "rms"                           # "rms" | "ln"
    act: str = "swiglu"                         # "swiglu" | "gelu"
    pos: str = "rope"                           # "rope" | "learned" | "none"
    use_bias: bool = False                      # linear/ln biases (GPT-2/BERT)
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    eps: float = 1e-5
    dtype: Any = torch.bfloat16                 # activation dtype
    param_dtype: Any = torch.float32

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def hd(self) -> int:
        return self.head_dim or self.hidden // self.num_heads

    def num_params(self) -> int:
        h, l = self.hidden, self.num_layers
        attn = h * self.num_heads * self.hd + 2 * h * self.kv_heads * self.hd \
            + self.num_heads * self.hd * h
        mlp = (3 if self.act == "swiglu" else 2) * h * self.mlp_dim
        norms = (2 * l + 1) * h
        if self.norm == "ln" or self.use_bias:
            norms *= 2  # scale + bias
        biases = 0
        if self.use_bias:
            biases = l * (
                self.num_heads * self.hd + 2 * self.kv_heads * self.hd + h
                + self.mlp_dim + h
            )
        embed = self.vocab_size * h * (1 if self.tie_embeddings else 2)
        pos = self.max_seq * h if self.pos == "learned" else 0
        return l * (attn + mlp) + norms + biases + embed + pos


def _norm_params(cfg: TransformerConfig, layers: Optional[int] = None):
    lead = (layers,) if layers else ()
    lead_ax = ("layers",) if layers else ()
    p = {"scale": (lead + (cfg.hidden,), lead_ax + ("embed_act",))}
    if cfg.norm == "ln" or cfg.use_bias:
        p["bias"] = (lead + (cfg.hidden,), lead_ax + ("embed_act",))
    return p


def abstract_params(cfg: TransformerConfig) -> dict:
    """A tree whose leaves are (shape, logical_axes) tuples — the same
    tree the JAX package builds for a dense model."""
    h, nh, kvh, hd, mlp, L = (cfg.hidden, cfg.num_heads, cfg.kv_heads,
                              cfg.hd, cfg.mlp_dim, cfg.num_layers)
    layer = {
        "attn_norm": _norm_params(cfg, L),
        "mlp_norm": _norm_params(cfg, L),
        "attn": {
            "wq": ((L, h, nh, hd), ("layers", "embed", "heads", "head_dim")),
            "wk": ((L, h, kvh, hd), ("layers", "embed", "kv_heads", "head_dim")),
            "wv": ((L, h, kvh, hd), ("layers", "embed", "kv_heads", "head_dim")),
            "wo": ((L, nh, hd, h), ("layers", "heads", "head_dim", "embed")),
        },
        "mlp": {
            "wi": ((L, h, mlp), ("layers", "embed", "mlp")),
            "wo": ((L, mlp, h), ("layers", "mlp", "embed")),
        },
    }
    if cfg.act == "swiglu":
        layer["mlp"]["wg"] = ((L, h, mlp), ("layers", "embed", "mlp"))
    if cfg.use_bias:
        layer["attn"]["bq"] = ((L, nh, hd), ("layers", "heads", "head_dim"))
        layer["attn"]["bk"] = ((L, kvh, hd), ("layers", "kv_heads", "head_dim"))
        layer["attn"]["bv"] = ((L, kvh, hd), ("layers", "kv_heads", "head_dim"))
        layer["attn"]["bo"] = ((L, h), ("layers", "embed_act"))
        layer["mlp"]["bi"] = ((L, mlp), ("layers", "mlp"))
        layer["mlp"]["bo"] = ((L, h), ("layers", "embed_act"))
    params = {
        "embed": {"tokens": ((cfg.vocab_size, h), ("vocab", "embed"))},
        "layers": layer,
        "final_norm": _norm_params(cfg),
    }
    if cfg.pos == "learned":
        params["embed"]["pos"] = ((cfg.max_seq, h), (None, "embed"))
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": ((h, cfg.vocab_size), ("embed", "vocab"))}
    return params


def _trunc_normal(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], by the inverse CDF of a
    uniform draw between the two bounds' CDF values."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    x = torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0) * math.sqrt(2.0)
    return x.clamp_(-2.0, 2.0)


def init(cfg: TransformerConfig, *, seed: int = 0, device: Any) -> dict:
    """Initialize params: truncated normal at ±2σ with σ=0.02, output
    projections ``wo`` divided by sqrt(2L), norm scales 1, biases 0 — the
    JAX package's init law. Draws come from a ``torch.Generator`` seeded
    with ``seed`` on ``device``, so the values differ from JAX's; tests
    carry JAX weights across with :func:`polyaxon_tpu_torch.convert.params_from_jax`."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def build(tree, name=None):
        if isinstance(tree, dict):
            return {k: build(v, k) for k, v in sorted(tree.items())}
        shape, _axes = tree
        if name == "scale":
            return torch.ones(shape, dtype=cfg.param_dtype, device=device)
        if name.startswith("b") or name == "bias":
            return torch.zeros(shape, dtype=cfg.param_dtype, device=device)
        w = _trunc_normal(shape, gen, device) * 0.02
        if name == "wo":  # residual-path projections
            w = w / (2 * cfg.num_layers) ** 0.5
        return w.to(cfg.param_dtype)

    return build(abstract_params(cfg))


def _norm(x: torch.Tensor, p: dict, cfg: TransformerConfig) -> torch.Tensor:
    if cfg.norm == "rms":
        return rms_norm(x, p["scale"], cfg.eps)
    bias = p.get("bias")
    if bias is None:
        bias = torch.zeros_like(p["scale"])
    return layer_norm(x, p["scale"], bias, cfg.eps)


def head_weights(params: dict, cfg: TransformerConfig) -> tuple[torch.Tensor, bool]:
    """LM-head weight and its orientation: (w, vocab_major). vocab_major
    means w is [vocab, hidden] (tied embeddings) vs [hidden, vocab]."""
    if cfg.tie_embeddings:
        return params["embed"]["tokens"], True
    return params["lm_head"]["w"], False
