"""Transformer config, parameter layout, init and the training forward
of the port.

Counterpart of ``polyaxon_tpu/models/transformer.py``: the config, the
parameter tree (the same nested-dict layout with layer-stacked ``[L, ...]``
leaves, so weights carry across unchanged), the init law, the layer body
with its remat policies, the mixture-of-experts MLP (top-k router, the
Switch balance term, capacity / all-to-all / dense dispatch),
``apply_hidden``/``apply`` and the (chunked) LM loss. Parameters are a
plain nested dict of tensors. The decode-mode layer loop of the serving
path lives in ``serve/model.py`` (the JAX serving model has no MoE branch,
and neither does the port's).

Over a mesh (``mesh=``, a process group) the training forward runs on this
rank's shards, as the JAX package's GSPMD program runs on a device's:

- ``model`` (tensor parallel, Megatron's layout, the JAX rules'): q/k/v and
  ``wi``/``wg`` are column-parallel over the rank's heads and mlp columns
  (their input's grad summed over model), ``wo`` of attention and MLP
  row-parallel (the partial products summed over model, the bias added
  once after the sum); the token table is vocab-parallel (each rank looks
  up the ids in its rows, the rest are zeros, then the sum), and so is
  the loss (the row max and the sum of exponentials over model, the gold
  logit from the rank that holds it), tied heads included;
- ``context``: the rank holds a chunk of the sequence, its RoPE tables and
  learned positions at the chunk's global positions; attention is ring
  attention over B1-B3 (``seq_parallel="ring"``, GQA kv compact on the
  ring) or Ulysses (``"ulysses"``, kv expanded first);
- ``expert`` (a batch axis): outside a pipeline the capacity plan, the
  drop fraction and the balance term are the whole batch's, as the JAX
  package's global dispatch computes them (the router's choices are
  gathered over the token ranks, each rank keeps its own tokens' rows);
  capacity and dense read every expert (gathered), all-to-all moves each
  rank's tokens to the experts' owners (``moe_dispatch="a2a"``);
- ``stage``: the trunk runs as a GPipe pipeline over the stage ranks
  (``parallel/pipeline.py``), each holding its block of the layers; inside
  a stage the MoE plan and balance are local to the rank's microbatch, as
  they are inside the JAX pipeline's shard_map.

The layers return ``(x, aux)`` with aux = [balance, drop fraction] (zeros
from a dense layer), averaged over layers by :func:`run_trunk`.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from ..ops.attention import attention, repeat_kv
from ..ops.gating import gated
from ..ops.layers import apply_rope, gelu, layer_norm, rms_norm, rope_frequencies, swiglu
from ..ops.ring_attention import ring_attention
from ..ops.ulysses import ulysses_attention
from ..parallel import collectives
from ..parallel.blocks import Law, init_tree, keyed, lead_of
from ..parallel.fsdp import ShardedTree, fresh
from ..parallel.mesh import BATCH_AXES, LOCAL, TOKEN_AXES, ShardingRules


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
    causal: bool = True
    attn_impl: str = "auto"                     # "auto" | "dense" | "flash"
    seq_parallel: str = "ring"                  # "ring" | "ulysses" (context axis >1)
    remat: str = "none"             # "none" | "full" | "attn" | "attn_qkv" | "dots"
    attn_block_q: int = 512
    attn_block_k: int = 512
    # backward flash blocks; 0 = the forward's
    attn_block_q_bwd: int = 0
    attn_block_k_bwd: int = 0
    loss_chunk_tokens: int = 4096               # blockwise-CE chunk; 0 = unchunked
    pp_microbatches: int = 0                    # GPipe microbatches; 0 = 2*stages
    # bubble ticks: "auto" is "inner" when the stage body has collectives
    # (model, context, expert a2a), else "full"; the port skips an idle
    # tick outright under both; "none" runs it and masks its aux
    pp_gate: str = "auto"                       # "auto" | "full" | "inner" | "none"
    pp_remat_ticks: bool = False                # keep each tick's input only
    # mixture of experts: >0 replaces each layer's MLP with num_experts
    # expert MLPs and a top-k router (the experts' leading dim is the
    # ``expert`` logical axis)
    num_experts: int = 0
    expert_top_k: int = 2
    moe_dispatch: str = "capacity"              # "capacity" | "a2a" | "dense"
    expert_capacity_factor: float = 1.25
    moe_cap_block: int = 0                      # >0: stream the capacity dim
    router_aux_coef: float = 0.01               # Switch balance coefficient

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def hd(self) -> int:
        return self.head_dim or self.hidden // self.num_heads

    def flops_per_token(self, seq_len: int) -> float:
        """Approximate training FLOPs/token (fwd+bwd = 6N_active + attention
        term); feeds the MFU meter."""
        attn = 12 * self.num_layers * self.hidden * seq_len  # qk+av fwd+bwd
        return 6 * self.active_params() + attn

    def active_params(self) -> int:
        """Params touched per token: every param for a dense model; an MoE
        layer's expert block counts top_k of its num_experts experts."""
        total = self.num_params()
        if not self.num_experts:
            return total
        k = min(self.expert_top_k, self.num_experts)
        per_expert = (3 if self.act == "swiglu" else 2) * self.hidden * self.mlp_dim
        return total - self.num_layers * (self.num_experts - k) * per_expert

    def num_params(self) -> int:
        h, l = self.hidden, self.num_layers
        attn = h * self.num_heads * self.hd + 2 * h * self.kv_heads * self.hd \
            + self.num_heads * self.hd * h
        mlp = (3 if self.act == "swiglu" else 2) * h * self.mlp_dim
        if self.num_experts:
            mlp = self.num_experts * mlp + h * self.num_experts  # + router
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
    """A tree whose leaves are (shape, logical_axes) tuples — the tree the
    JAX package builds (an MoE layer's MLP: the router ``(L, h, E)`` and
    E-stacked experts on the ``expert`` axis)."""
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
    }
    if cfg.num_experts:
        E = cfg.num_experts
        layer["mlp"] = {
            "router": ((L, h, E), ("layers", "embed", None)),
            "wi": ((L, E, h, mlp), ("layers", "expert", "embed", "mlp")),
            "wo": ((L, E, mlp, h), ("layers", "expert", "mlp", "embed")),
        }
        if cfg.act == "swiglu":
            layer["mlp"]["wg"] = ((L, E, h, mlp), ("layers", "expert", "embed", "mlp"))
    else:
        layer["mlp"] = {
            "wi": ((L, h, mlp), ("layers", "embed", "mlp")),
            "wo": ((L, mlp, h), ("layers", "mlp", "embed")),
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
    if cfg.num_experts and cfg.use_bias:
        raise ValueError("MoE layers do not support use_bias")
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


def _is_leaf(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], tuple)


def param_specs(cfg: TransformerConfig, rules: Optional[ShardingRules] = None) -> dict:
    """The PartitionSpec tree matching :func:`init`'s params, from each
    leaf's logical axes (the JAX package's ``param_specs``)."""
    rules = rules or ShardingRules()

    def build(tree):
        if _is_leaf(tree):
            return rules.spec(tree[1])
        return {k: build(v) for k, v in tree.items()}

    return build(abstract_params(cfg))


def param_laws(cfg: TransformerConfig) -> dict:
    """The init law of every leaf (:class:`~..parallel.blocks.Law`, keyed
    by its path): truncated normal at ±2σ with σ=0.02, output projections
    ``wo`` divided by sqrt(2L), norm scales 1, biases 0 — the JAX package's
    law. A stacked leaf's slices are its layers, an expert stack's its
    (layer, expert) pairs."""

    def build(tree, name=None):
        if isinstance(tree, dict):
            return {k: build(v, k) for k, v in sorted(tree.items())}
        shape, axes = tree
        lead = lead_of(axes)
        if name == "scale":
            return Law(shape, "ones", lead=lead, dtype=cfg.param_dtype)
        if name.startswith("b") or name == "bias":
            return Law(shape, "zeros", lead=lead, dtype=cfg.param_dtype)
        # residual-path projections
        scale = 0.02 / (2 * cfg.num_layers) ** 0.5 if name == "wo" else 0.02
        return Law(shape, "trunc_normal", scale, lead, cfg.param_dtype)

    return keyed(build(abstract_params(cfg)))


def init(cfg: TransformerConfig, *, seed: int = 0, device: Any) -> dict:
    """Initialize params by :func:`param_laws`: each slice (a layer, an
    expert of a layer, a leaf without layers) from a ``torch.Generator`` of
    its own seeded from (``seed``, its path, its indices) on ``device``, so
    a rank can build its block alone (``parallel/blocks.py``). The values
    differ from JAX's; tests carry JAX weights across with
    :func:`polyaxon_tpu_torch.convert.params_from_jax`."""
    return init_tree(param_laws(cfg), seed, device)


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


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------


def _qkv(x, lp, cfg: TransformerConfig, rope_tables, mesh=None, active=None):
    """Norm, q/k/v projections and rope: [b, s, h] -> three [b, n, s, d]
    (under ``model``, n is the rank's heads: column-parallel). Gated as one
    segment (``active``)."""

    def fn(x):
        b, s, h = x.shape
        dt = cfg.dtype
        ap = lp["attn"]
        y = _norm(x, lp["attn_norm"], cfg)
        if mesh is not None:
            y = mesh.to_model(y)

        def proj(w, bias):
            n, d = w.shape[1], w.shape[2]
            out = torch.matmul(y, w.to(dt).reshape(h, n * d)).view(b, s, n, d)
            if bias is not None:
                out = out + bias.to(dt)
            return out.transpose(1, 2)

        use = cfg.use_bias
        q = proj(ap["wq"], ap["bq"] if use else None)
        k = proj(ap["wk"], ap["bk"] if use else None)
        v = proj(ap["wv"], ap["bv"] if use else None)
        if cfg.pos == "rope":
            cos, sin = rope_tables
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
        return q, k, v

    return gated(active, fn, x)


def _attend(q, k, v, cfg: TransformerConfig, mesh=None, active=None):
    """GQA attention (causal or not, as ``cfg.causal`` says), heads merged:
    [b, s, n*d] (the JAX package's ``attn_out`` save) — the JAX package's
    ``_sharded_attention`` and, inside a pipeline stage, its
    ``_inner_attention`` (the port's collectives are explicit in both).
    With a ``context`` axis the sequence is cut over ranks: ring attention
    keeps the kv heads compact; Ulysses expands them first. The local
    kernel is gated (``active``); the ring's and Ulysses' exchanges run
    whatever the gate, and an inactive tick's output is zeros."""
    b, n, s, d = q.shape
    cp = mesh.cp if mesh is not None else 1
    if cp > 1 and cfg.seq_parallel == "ring":
        o = ring_attention(q, k, v, exchange=mesh.ring(), causal=cfg.causal,
                           block_q=min(cfg.attn_block_q, s),
                           block_k=min(cfg.attn_block_k, k.shape[2]))
        o = gated(active, lambda o: o, o)
    elif cp > 1:
        o = ulysses_attention(q, repeat_kv(k, n), repeat_kv(v, n),
                              group=mesh.group("context"), size=cp, causal=cfg.causal,
                              impl=cfg.attn_impl)
        o = gated(active, lambda o: o, o)
    else:
        o = gated(active, lambda q, k, v: attention(
            q, k, v, causal=cfg.causal, impl=cfg.attn_impl,
            block_q=min(cfg.attn_block_q, s), block_k=min(cfg.attn_block_k, k.shape[2]),
            block_q_bwd=cfg.attn_block_q_bwd or None,
            block_k_bwd=cfg.attn_block_k_bwd or None), q, k, v)
    return o.transpose(1, 2).reshape(b, s, n * d)


def _row_parallel(y, w, bias, mesh, active=None):
    """``y @ w`` whose contracted dim is cut over model: each rank's partial
    product, summed over model, then ``bias`` once (added before the sum,
    a replicated bias would count once per rank). The product and the
    bias are gated (``active``), the sum is not."""
    out = gated(active, torch.matmul, y, w)
    if mesh is not None:
        out = mesh.from_model(out)
    return out if bias is None else gated(active, torch.add, out, bias)


def _zero_aux(x: torch.Tensor) -> torch.Tensor:
    """A dense layer's aux: [balance, drop fraction] = 0."""
    return torch.zeros(2, dtype=torch.float32, device=x.device)


def _out_mlp(x, o, lp, cfg: TransformerConfig, mesh=None, inner=None, active=None):
    """Out projection, residual, norm, MLP (dense or mixture of experts),
    residual; returns ``(x, aux)`` (under ``model``: the MLP's columns
    this rank's, both out projections row-parallel, an MoE output summed
    over model unless the all-to-all dispatch summed it)."""
    dt = cfg.dtype
    ap, mp = lp["attn"], lp["mlp"]
    h = x.shape[-1]
    bias = (lambda t: t.to(dt)) if cfg.use_bias else (lambda t: None)  # noqa: E731
    o = _row_parallel(o, ap["wo"].to(dt).reshape(-1, h), bias(ap.get("bo")), mesh, active)
    def resid_norm(x, o):
        x = x + o
        return x, _norm(x, lp["mlp_norm"], cfg)

    x, y = gated(active, resid_norm, x, o)
    if cfg.num_experts:
        out, aux = _moe_mlp(y, mp, cfg, mesh=mesh, inner=inner, active=active)
        if mesh is not None and cfg.moe_dispatch != "a2a":
            out = mesh.from_model(out)
        return x + out, aux
    if mesh is not None:
        y = mesh.to_model(y)

    def mlp_fn(y):
        if cfg.act == "swiglu":
            return swiglu(torch.matmul(y, mp["wi"].to(dt)), torch.matmul(y, mp["wg"].to(dt)))
        hidden = torch.matmul(y, mp["wi"].to(dt))
        if cfg.use_bias:
            hidden = hidden + mp["bi"].to(dt)
        return gelu(hidden)

    hidden = gated(active, mlp_fn, y)
    return x + _row_parallel(hidden, mp["wo"].to(dt), bias(mp.get("bo")), mesh, active), \
        _zero_aux(x)


def _layer_body(x, lp, cfg: TransformerConfig, rope_tables, mesh=None, inner=None,
                active=None):
    """One transformer layer, no remat: ``(x, aux)``. ``active`` gates
    each compute segment (an inactive body emits exact zeros, aux too);
    the collectives between the segments run whatever the gate."""
    q, k, v = _qkv(x, lp, cfg, rope_tables, mesh, active)
    return _out_mlp(x, _attend(q, k, v, cfg, mesh, active), lp, cfg, mesh, inner, active)


# ---------------------------------------------------------------------------
# Mixture of experts
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InnerAxes:
    """The axes a layer body runs over inside a pipeline stage (the JAX
    package's manual-collective mode): model (tp), context (cp) and the
    expert group of the all-to-all dispatch (ep_size). Inside a stage the
    MoE plan and balance are local to the rank's microbatch."""

    tp: bool = False
    cp: bool = False
    ep_size: int = 1


def _global_mesh(mesh, inner):
    """The mesh whose token ranks the router's plan and balance span: the
    whole batch's outside a pipeline, None (local) inside one or without
    a token group."""
    if inner is not None or mesh is None or not mesh.distributed:
        return None
    return None if mesh.group(*TOKEN_AXES) is LOCAL else mesh


def _top_k(logits: torch.Tensor, k: int):
    """The k largest values and their indices, ties to the lowest index
    first (``jax.lax.top_k``'s order; ``torch.topk`` does not promise one):
    a stable descending sort."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(y, router, E: int, k: int, gmesh=None):
    """The router (f32): top-k experts per token, the softmax over their
    logits, and the Switch balance ``E * sum_e f_e P_e`` (f_e: the share
    of assignments on expert e, P_e: its mean probability; 1.0 at perfect
    balance, E when collapsed). With ``gmesh`` both means are the whole
    batch's (P's sum differentiable over the token ranks)."""
    logits = torch.einsum("bsh,he->bse", y.float(), router.float())
    top_vals, top_idx = _top_k(logits, k)
    top_gates = torch.softmax(top_vals, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    sel = torch.nn.functional.one_hot(top_idx, E).float()   # [b,s,k,E]
    if gmesh is None:
        f = sel.sum(dim=2).mean(dim=(0, 1)) / k
        p_mean = probs.mean(dim=(0, 1))
    else:
        group = gmesh.group(*TOKEN_AXES)
        count = y.shape[0] * y.shape[1] * gmesh.axis_size(*TOKEN_AXES)
        f = collectives.sum_over(sel.sum(dim=(0, 1, 2)), group) / count / k
        p_mean = collectives.differentiable_sum(probs.sum(dim=(0, 1)), group) / count
    return top_idx, top_gates, E * (f * p_mean).sum()


def _moe_mlp(y, mp, cfg: TransformerConfig, mesh=None, inner=None, active=None):
    """Top-k routed expert MLPs (``cfg.moe_dispatch``); returns ``(out,
    aux)`` with aux = [balance, fraction of assignments dropped at
    capacity]. Under ``model`` the output is this rank's partial sum
    (capacity, dense) or the whole sum (a2a)."""
    E, k = cfg.num_experts, min(cfg.expert_top_k, cfg.num_experts)
    gmesh = _global_mesh(mesh, inner)
    top_idx, top_gates, balance = gated(
        active, lambda yy: _route(yy, mp["router"], E, k, gmesh), y)
    if cfg.moe_dispatch == "dense":
        out = gated(active, lambda yy, ti, tg: _moe_dense(yy, mp, cfg, ti, tg, mesh),
                    y, top_idx, top_gates)
        drop = torch.zeros((), dtype=torch.float32, device=y.device)
    elif cfg.moe_dispatch == "capacity":
        out, drop = gated(active, lambda yy, ti, tg: _moe_capacity(
            yy, mp, cfg, ti, tg, mesh, gmesh), y, top_idx, top_gates)
    elif cfg.moe_dispatch == "a2a":
        out, drop = _moe_a2a(y, mp, cfg, top_idx, top_gates, mesh, inner, active)
    else:
        raise ValueError(f"unknown moe_dispatch {cfg.moe_dispatch!r}; "
                         f"valid: capacity|a2a|dense")
    return out, torch.stack([balance.float(), drop.float()])


def _expert_ffn(xin, mp, cfg: TransformerConfig):
    """The expert MLP stack over [E, ..., h] inputs (batched products)."""
    dt = cfg.dtype
    e, h = xin.shape[0], xin.shape[-1]
    x3 = xin.reshape(e, -1, h)
    hi = torch.bmm(x3, mp["wi"].to(dt))
    if cfg.act == "swiglu":
        inner = swiglu(hi, torch.bmm(x3, mp["wg"].to(dt)))
    else:
        inner = gelu(hi)
    out = torch.bmm(inner, mp["wo"].to(dt))
    return out.reshape(xin.shape[:-1] + (out.shape[-1],))


def _tp_in(t, mesh):
    """A replicated input of a model-partial computation: its grad summed
    over model (Megatron's f)."""
    return t if mesh is None else mesh.to_model(t)


def _moe_dense(y, mp, cfg: TransformerConfig, top_idx, top_gates, mesh=None):
    """Every expert on every token, the gates masking the combine (no
    drops; the parity oracle)."""
    dt = cfg.dtype
    E = cfg.num_experts
    gates = torch.zeros(y.shape[:2] + (E,), dtype=torch.float32, device=y.device)
    gates = gates.scatter(-1, top_idx, top_gates.float())          # [b,s,E]
    xe = _tp_in(y, mesh)
    ye = _expert_ffn(xe[None].expand((E,) + tuple(xe.shape)), mp, cfg)
    return torch.einsum("ebsh,bse->bsh", ye, _tp_in(gates, mesh).to(dt))


def _capacity_plan(top_idx, top_gates, E: int, k: int, cap: int):
    """Each (token, choice) assignment's slot in its expert's fixed [cap]
    buffer: (e, t, g, slot, keep, drop) — the per-assignment expert, token
    and gate (token order; g None without gates), each kept assignment's
    slot and the dropped fraction. Positions come from an int32 cumsum
    over the one-hot selection, so slot order within an expert is token
    order. The cumsum runs along the inner dim of the [E, T*k] transpose
    (a scan along the outer dim of [T*k, E] runs one thread per expert)."""
    T = top_idx.shape[0]
    flat_e = top_idx.reshape(T * k)
    flat_g = None if top_gates is None else top_gates.reshape(T * k).float()
    flat_t = torch.arange(T, device=top_idx.device).repeat_interleave(k)
    sel = torch.nn.functional.one_hot(flat_e, E).to(torch.int32).t().contiguous()  # [E, T*k]
    counts = torch.cumsum(sel, dim=1, dtype=torch.int32)
    pos = counts.gather(0, flat_e[None]).squeeze(0) - 1
    keep = pos < cap
    slot = torch.where(keep, pos, torch.zeros_like(pos)).long()
    drop = 1.0 - keep.float().mean()
    return flat_e, flat_t, flat_g, slot, keep, drop


def _dispatch_tables(top_idx, top_gates, E: int, k: int, cap: int):
    """Gather-form dispatch plan: (token_for_slot [E, cap], slot [T, k],
    keep [T, k], drop). Empty slots point at the sentinel row T (the
    gathers pad a zero row); dropped assignments land in the discarded
    overflow column ``cap``."""
    T = top_idx.shape[0]
    ae, at_, _, slot, keep, drop = _capacity_plan(top_idx, top_gates, E, k, cap)
    tfs = torch.full((E, cap + 1), T, dtype=torch.long, device=top_idx.device)
    tfs[ae, torch.where(keep, slot, torch.full_like(slot, cap))] = at_
    return tfs[:, :cap], slot.reshape(T, k), keep.reshape(T, k), drop


class _GatherDispatch(torch.autograd.Function):
    """xin[e, c] = x[tfs[e, c]] ([E, cap, h]; the sentinel row reads
    zeros). The backward is a per-token gather, not autograd's
    scatter-add: dx[t] = sum_j keep[t,j] * dxin[top_idx[t,j], slot[t,j]]."""

    @staticmethod
    def forward(ctx, x, tfs, top_idx, slot, keep):
        ctx.save_for_backward(top_idx, slot, keep)
        xp = torch.cat([x, x.new_zeros((1, x.shape[1]))], dim=0)
        return xp[tfs]

    @staticmethod
    def backward(ctx, dxin):
        top_idx, slot, keep = ctx.saved_tensors
        dx = torch.einsum("tkh,tk->th", dxin[top_idx, slot], keep.to(dxin.dtype))
        return dx, None, None, None, None


class _GatherCombine(torch.autograd.Function):
    """out[t] = sum_j w[t,j] * ye[top_idx[t,j], slot[t,j]] ([T, h]); ``w``
    [T, k] f32 carries the gates (zero where dropped). The backward
    gathers both ways: dye through the token-for-slot table, in the
    activation dtype, and dw (f32) through the forward's gather."""

    @staticmethod
    def forward(ctx, ye, w, tfs, top_idx, slot, keep):
        ctx.save_for_backward(ye, w, tfs, top_idx, slot, keep)
        return torch.einsum("tkh,tk->th", ye[top_idx, slot], w.to(ye.dtype))

    @staticmethod
    def backward(ctx, dout):
        ye, w, tfs, top_idx, slot, keep = ctx.saved_tensors
        E, cap, h = ye.shape
        w_slot = torch.zeros((E, cap + 1), dtype=torch.float32, device=ye.device)
        w_slot[top_idx, torch.where(keep, slot, torch.full_like(slot, cap))] = w.float()
        dout_pad = torch.cat([dout, dout.new_zeros((1, h))], dim=0)
        dye = (w_slot[:, :cap].to(dout.dtype)[..., None] * dout_pad[tfs]).to(ye.dtype)
        dw = torch.einsum("tkh,th->tk", ye[top_idx, slot].float(), dout.float())
        return dye, dw, None, None, None, None


def _global_plan(top_idx, E: int, k: int, cf: float, gmesh):
    """The capacity plan over the whole batch, in the global token order
    (row, position) JAX's sharded batch has; this rank keeps its own
    tokens' rows: (tfs over local rows, slot, keep, global drop)."""
    b, s = top_idx.shape[:2]
    nb, cp = gmesh.axis_size(*BATCH_AXES), gmesh.cp
    g = collectives.gather_rows(top_idx, gmesh.group(*TOKEN_AXES), nb * cp)
    B, S = nb * b, cp * s
    glob = g.view(nb, cp, b, s, k).permute(0, 2, 1, 3, 4).reshape(B * S, k)
    cap = max(int(B * S * k / E * cf), 1)
    tfs_g, slot_g, keep_g, drop = _dispatch_tables(glob, None, E, k, cap)
    dev = top_idx.device
    rows = gmesh.index(BATCH_AXES) * b + torch.arange(b, device=dev)
    cols = gmesh.seq_index * s + torch.arange(s, device=dev)
    mine = (rows[:, None] * S + cols[None, :]).reshape(-1)
    loc = torch.full((B * S + 1,), b * s, dtype=torch.long, device=dev)
    loc[mine] = torch.arange(b * s, device=dev)
    return loc[tfs_g], slot_g[mine], keep_g[mine], drop, cap


def _moe_capacity(y, mp, cfg: TransformerConfig, top_idx, top_gates, mesh=None,
                  gmesh=None):
    """Capacity dispatch: tokens gather into each expert's fixed [cap, h]
    block, assignments past capacity drop (their combine weight is zero);
    both data movements are gathers from the plan's index tables. With
    ``gmesh`` the plan is the whole batch's (``cap`` from every token);
    with ``cfg.moe_cap_block`` > 0 the capacity dim streams."""
    dt = cfg.dtype
    b, s, h = y.shape
    E, k = cfg.num_experts, min(cfg.expert_top_k, cfg.num_experts)
    T = b * s
    x = _tp_in(y, mesh).reshape(T, h)
    ti, tg = top_idx.reshape(T, k), top_gates.reshape(T, k)
    if gmesh is not None:
        tfs, slot, keep, drop, cap = _global_plan(top_idx, E, k, cfg.expert_capacity_factor,
                                                  gmesh)
    else:
        cap = max(int(T * k / E * cfg.expert_capacity_factor), 1)
        tfs, slot, keep, drop = _dispatch_tables(ti, tg, E, k, cap)
    tg = _tp_in(tg, mesh)
    if cfg.moe_cap_block and cap > cfg.moe_cap_block:
        out = _moe_capacity_streamed(x, mp, cfg, tfs, ti, tg, slot, keep, cap,
                                     cfg.moe_cap_block)
    else:
        xin = _GatherDispatch.apply(x, tfs, ti, slot, keep)        # [E, cap, h]
        ye = _expert_ffn(xin, mp, cfg)
        w = tg.float() * keep.float()
        out = _GatherCombine.apply(ye, w, tfs, ti, slot, keep)     # [T, h]
    return out.to(dt).reshape(b, s, h), drop


def _moe_capacity_streamed(x, mp, cfg, tfs, ti, tg, slot, keep, cap, cb):
    """Cap-blocked dispatch: per chunk of ``cb`` expert slots, gather its
    tokens, run the expert FFN and combine into an f32 [T, h] accumulator;
    each chunk's body is recomputed in the backward (``checkpoint``, as
    ``jax.checkpoint`` on the JAX scan body), so only [E, cb, *] buffers
    live at once. ``cap`` pads to a multiple of ``cb`` with sentinel
    slots."""
    T, h = x.shape
    E = tfs.shape[0]
    nc = -(-cap // cb)
    if nc * cb != cap:
        tfs = torch.cat([tfs, torch.full((E, nc * cb - cap), T, dtype=tfs.dtype,
                                         device=tfs.device)], dim=1)

    def body(x, tg, lo):
        in_chunk = keep & (slot >= lo) & (slot < lo + cb)
        slot_l = (slot - lo).clamp(0, cb - 1)
        tfs_c = tfs[:, lo:lo + cb]
        xin_c = _GatherDispatch.apply(x, tfs_c, ti, slot_l, in_chunk)
        ye_c = _expert_ffn(xin_c, mp, cfg)                          # [E, cb, h]
        w_c = tg.float() * in_chunk.float()
        return _GatherCombine.apply(ye_c, w_c, tfs_c, ti, slot_l, in_chunk)

    acc = torch.zeros((T, h), dtype=torch.float32, device=x.device)
    for c in range(nc):
        acc = acc + _ckpt(body, x, tg, c * cb).float()
    return acc


def _moe_a2a_local(y, top_idx, top_gates, mp, cfg: TransformerConfig, group, ep_size: int,
                   mesh=None, active=None):
    """A rank's half of the all-to-all dispatch: its tokens' assignments
    gather into per-expert send buffers [E, cap, h] (``cap`` per source
    rank and expert), one all-to-all over the expert group delivers each
    owner its tokens, its E/ep experts run on [E/ep, ep*cap, h], and a
    reverse all-to-all brings the outputs home for the gated combine. The
    plan, the FFN and the combine are gated (``active``); the all-to-alls
    and the model sum run whatever the gate."""
    dt = cfg.dtype
    b, s, h = y.shape
    E, k = cfg.num_experts, min(cfg.expert_top_k, cfg.num_experts)
    e_loc = E // ep_size
    T = b * s
    cap = max(int(T * k / E * cfg.expert_capacity_factor), 1)
    x = _tp_in(y, mesh).reshape(T, h)
    ti, tg = top_idx.reshape(T, k), top_gates.reshape(T, k)

    def dispatch_fn(x, ti, tg):
        tfs, slot, keep, drop = _dispatch_tables(ti, tg, E, k, cap)
        return _GatherDispatch.apply(x, tfs, ti, slot, keep), tfs, slot, keep, drop

    xin, tfs, slot, keep, drop = gated(active, dispatch_fn, x, ti, tg)
    if ep_size > 1:
        # block p of dim 0 -> expert rank p; received block j came from rank j
        recv = collectives.all_to_all(xin.reshape(ep_size, e_loc, cap, h), group)
        xin_loc = recv.transpose(0, 1).reshape(e_loc, ep_size * cap, h)
    else:
        xin_loc = xin
    ye = gated(active, lambda xi: _expert_ffn(xi, mp, cfg), xin_loc)
    if mesh is not None:
        ye = mesh.from_model(ye)
    if ep_size > 1:
        back = collectives.all_to_all(ye.reshape(e_loc, ep_size, cap, h).transpose(0, 1),
                                      group)
        ye = back.reshape(E, cap, h)

    def combine_fn(ye, tg):
        w = tg.float() * keep.float()
        return _GatherCombine.apply(ye, w, tfs, ti, slot, keep).to(dt)

    out = gated(active, combine_fn, ye, tg)
    return out.reshape(b, s, h), drop


def _moe_a2a(y, mp, cfg: TransformerConfig, top_idx, top_gates, mesh, inner,
             active=None):
    """The all-to-all dispatch over the ``expert`` group (each rank holds
    E/ep experts; one rank: the same arithmetic without exchanges). The
    plan is local to the rank's tokens; its drop fraction is the rank's,
    which the task averages over the batch ranks."""
    ep = mesh.ep if mesh is not None else 1
    if cfg.num_experts % ep:
        raise ValueError(f"num_experts {cfg.num_experts} not divisible by expert mesh "
                         f"axis {ep}")
    group = mesh.group("expert") if ep > 1 else None
    return _moe_a2a_local(y, top_idx, top_gates, mp, cfg, group, ep, mesh, active)


# ---------------------------------------------------------------------------
# Remat and the trunk
# ---------------------------------------------------------------------------


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the outputs of matrix products without batch dimensions (the
    projections' ``torch.matmul`` folds to ``aten.mm``), recompute the rest."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _ckpt(fn, *args, **kwargs):
    return checkpoint(fn, *args, use_reentrant=False, **kwargs)


def _remat_layer(x, lp, cfg: TransformerConfig, rope_tables, mesh=None, inner=None,
                 active=None):
    """One layer under ``cfg.remat``: ``(x, aux)``. Each policy keeps for
    the backward what the JAX policy saves and recomputes the rest (the
    layer input is always kept, as the scan carry is):

    - none: everything autograd saves;
    - full: nothing more; the whole layer reruns in the backward;
    - attn: the merged attention output (``attn_out``);
    - attn_qkv: ``attn_out`` and the post-rope q/k/v (``qkv``);
    - dots: the outputs of matrix products without batch dimensions.

    Under every policy but none the flash forward reruns in the backward
    (its LSE is not kept), as it does under the JAX policies. Under fsdp
    (``lp`` a :class:`~..parallel.fsdp.ShardedTree`) each recomputed part
    reads a fresh view, so the backward gathers its params again instead
    of keeping the gathered layer.
    """
    args = (mesh, inner, active)
    if cfg.remat == "none":
        return _layer_body(x, lp, cfg, rope_tables, *args)
    if cfg.remat == "full":
        return _ckpt(lambda x: _layer_body(x, fresh(lp), cfg, rope_tables, *args), x)
    if cfg.remat == "attn":
        o = _ckpt(lambda x: _attend(*_qkv(x, fresh(lp), cfg, rope_tables, mesh, active), cfg,
                                    mesh, active), x)
        return _ckpt(lambda x, o: _out_mlp(x, o, fresh(lp), cfg, *args), x, o)
    if cfg.remat == "attn_qkv":
        q, k, v = _ckpt(lambda x: _qkv(x, fresh(lp), cfg, rope_tables, mesh, active), x)
        o = _ckpt(lambda q, k, v: _attend(q, k, v, cfg, mesh, active), q, k, v)
        return _ckpt(lambda x, o: _out_mlp(x, o, fresh(lp), cfg, *args), x, o)
    if cfg.remat == "dots":
        return _ckpt(lambda x: _layer_body(x, fresh(lp), cfg, rope_tables, *args), x,
                     context_fn=functools.partial(create_selective_checkpoint_contexts,
                                                  _dots_policy))
    raise ValueError(f"unknown remat policy {cfg.remat!r}; "
                     f"valid: none|full|attn|attn_qkv|dots")


def flatten(tree: dict, prefix: tuple = ()) -> list:
    """(path, leaf) pairs of a param tree in sorted-key order (the JAX
    tree's leaf order)."""
    out = []
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            out.extend(flatten(value, prefix + (key,)))
        else:
            out.append((prefix + (key,), value))
    return out


def unflatten(paths, leaves) -> dict:
    tree: dict = {}
    for path, leaf in zip(paths, leaves):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def _unstack(tree: dict, n: int) -> list:
    """Stacked ``[L, ...]`` layer params -> L per-layer trees. One unbind
    per leaf, so the backward stacks the layers' grads once instead of
    adding L full-size zero-padded slices."""
    paths, leaves = zip(*flatten(tree))
    parts = [torch.unbind(t, 0) for t in leaves]
    return [unflatten(paths, [p[i] for p in parts]) for i in range(n)]


def _layer_count(layers) -> int:
    """The leading (layer) dim of a stacked tree: this rank's block of
    the layers under ``stage``."""
    leaves = layers.leaves() if isinstance(layers, ShardedTree) else \
        [t for _, t in flatten(layers)]
    return leaves[0].shape[0]


def _scan_layers(x, layers, cfg: TransformerConfig, rope_tables=None, mesh=None,
                 inner=None, active=None):
    """The stacked layers over ``x`` under ``cfg.remat``: ``(x, aux)``, aux
    averaged over the layers. fsdp shards (a ``ShardedTree``) unstack into
    per-layer views that gather each layer's params when it runs."""
    n = _layer_count(layers)
    unstack = getattr(layers, "unstack", None)
    per_layer = unstack(n) if unstack else _unstack(layers, n)
    auxes = []
    for lp in per_layer:
        x, aux = _remat_layer(x, lp, cfg, rope_tables, mesh, inner, active)
        auxes.append(aux)
    return x, torch.stack(auxes).mean(dim=0)


def run_trunk(x: torch.Tensor, layers: dict, cfg: TransformerConfig,
              rope_tables=None, mesh=None):
    """The stacked layers over ``x`` [batch, seq, hidden]: ``(x, aux)``;
    shared by :func:`apply_hidden` and encoder-only models (ViT). With a
    ``stage`` axis the trunk runs as a GPipe pipeline over the stage ranks
    (``layers`` is this rank's block of them), its stage bodies gated as
    ``cfg.pp_gate`` says."""
    if mesh is not None and mesh.pp > 1:
        from ..parallel.pipeline import gpipe_trunk

        ep = mesh.ep
        if cfg.num_experts and ep > 1:
            if cfg.moe_dispatch != "a2a":
                raise ValueError(
                    f"pipeline with expert={ep} needs moe_dispatch='a2a': "
                    f"{cfg.moe_dispatch!r} dispatch assumes every expert is device-local, "
                    f"but each stage shard holds only num_experts/{ep} of them")
            if cfg.num_experts % ep:
                raise ValueError(f"num_experts {cfg.num_experts} not divisible by expert "
                                 f"mesh axis {ep}")
        inner = InnerAxes(tp=mesh.tp, cp=mesh.cp > 1, ep_size=ep)
        # the expert all-to-all exists only in MoE layers: a dense model on
        # an expert axis takes the whole-body gate
        has_collectives = inner.tp or inner.cp or bool(cfg.num_experts and ep > 1)
        gate = cfg.pp_gate
        if gate == "auto":
            gate = "inner" if has_collectives else "full"
        elif gate == "full" and has_collectives:
            raise ValueError("pp_gate='full' is unsound for stage bodies with collectives "
                             "(TP/CP/EP) — use 'auto', 'inner', or 'none'")

        def body(xl, lp, active=None):
            return _scan_layers(xl, lp, cfg, rope_tables, mesh, inner, active)

        return gpipe_trunk(x, layers, body, mesh, num_microbatches=cfg.pp_microbatches,
                           gate=gate, remat_ticks=cfg.pp_remat_ticks,
                           num_layers=cfg.num_layers)
    return _scan_layers(x, layers, cfg, rope_tables, mesh)


def _vocab_block(mesh, n: int) -> int:
    """First vocab id of this rank's ``n`` rows of a vocab-parallel table
    (0 off the model axis)."""
    return mesh.coords()["model"] * n if mesh is not None and mesh.tp else 0


def _embed(table: torch.Tensor, tokens: torch.Tensor, dt, mesh=None) -> torch.Tensor:
    """Token embedding; under ``model`` the table is this rank's vocab rows:
    ids outside them read zeros, and the sum over model holds each id's
    row from the rank that has it."""
    if mesh is None or not mesh.tp:
        return table.to(dt)[tokens]
    n = table.shape[0]
    local = tokens - _vocab_block(mesh, n)
    inside = (local >= 0) & (local < n)
    rows = table.to(dt)[local.clamp(0, n - 1)]
    return mesh.from_model(torch.where(inside[..., None], rows, torch.zeros_like(rows)))


def _seq_offset(s: int, mesh=None) -> int:
    """Global position of this rank's first token: its chunk of the
    sequence under ``context``."""
    return mesh.seq_index * s if mesh is not None else 0


def apply_hidden(params: dict, tokens: Optional[torch.Tensor], cfg: TransformerConfig, *,
                 inputs_embeds: Optional[torch.Tensor] = None, mesh=None,
                 return_aux: bool = False):
    """Trunk forward: tokens [batch, seq] -> final-norm hidden states
    [batch, seq, hidden] in the activation dtype (and, with
    ``return_aux``, the layers' mean aux [balance, drop fraction]).
    ``inputs_embeds`` [batch, seq, hidden] takes the place of the token
    embedding. The vocab projection is left to the caller (the training
    loss fuses it blockwise). With ``mesh``, seq is this rank's chunk of
    the sequence, positioned at its global offset."""
    dt = cfg.dtype
    if inputs_embeds is None:
        x = _embed(params["embed"]["tokens"], tokens, dt, mesh)
    else:
        x = inputs_embeds.to(dt)
    s = x.shape[1]
    start = _seq_offset(s, mesh)
    if cfg.pos == "learned":
        x = x + params["embed"]["pos"].to(dt)[None, start:start + s]
    rope_tables = None
    if cfg.pos == "rope":
        if start + s > cfg.max_seq:
            raise ValueError(f"sequence length {start + s} exceeds max_seq {cfg.max_seq}: "
                             f"RoPE positions would silently clamp")
        cos, sin = rope_frequencies(cfg.hd, cfg.max_seq, cfg.rope_theta, device=x.device)
        rope_tables = (cos[start:start + s], sin[start:start + s])
    x, aux = run_trunk(x, params["layers"], cfg, rope_tables, mesh)
    hidden = _norm(x, params["final_norm"], cfg)
    return (hidden, aux) if return_aux else hidden


def apply(params: dict, tokens: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """Full forward: tokens [batch, seq] -> logits [batch, seq, vocab] (f32)."""
    x = apply_hidden(params, tokens, cfg)
    w, vocab_major = head_weights(params, cfg)
    w = w.to(cfg.dtype)
    return torch.matmul(x, w.t() if vocab_major else w).float()


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross entropy in f32; mask=0 positions excluded."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _chunk_nll(x, w, labels, vocab_major: bool, mesh=None):
    """Per-token NLL for one chunk: project to vocab in the activation
    dtype, reduce in f32. The chunk's logits are the only vocab-sized live
    tensor. Under ``model`` the logits are this rank's vocab columns: the
    row max and the sum of exponentials are taken over model (as
    ``logsumexp`` takes them, the max without a grad), the gold logit from
    the rank that holds the label."""
    w = w.to(x.dtype)
    logits = torch.matmul(x, w.t() if vocab_major else w).float()
    if mesh is None or not mesh.tp:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        return logz - gold
    n = logits.shape[-1]
    m = mesh.max_over_model_(logits.detach().amax(dim=-1))
    sumexp = mesh.from_model(torch.exp(logits - m[..., None]).sum(dim=-1))
    local = labels.long() - _vocab_block(mesh, n)
    inside = (local >= 0) & (local < n)
    gold = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = mesh.from_model(torch.where(inside, gold, torch.zeros_like(gold)))
    return m + torch.log(sumexp) - gold


def loss_chunks(batch: int, seq: int, chunk_tokens: int) -> int:
    """Chunk count of the blockwise loss: the smallest count that divides
    seq and keeps a chunk within the token budget (1 = unchunked)."""
    if not chunk_tokens or batch * seq <= chunk_tokens:
        return 1
    return next((c for c in range(1, seq + 1)
                 if seq % c == 0 and (seq // c) * batch <= chunk_tokens), seq)


def lm_loss_from_hidden(
    x: torch.Tensor,
    w: torch.Tensor,
    labels: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    vocab_major: bool = False,
    chunk_tokens: int = 4096,
    mesh=None,
) -> torch.Tensor:
    """Blockwise fused vocab projection + cross entropy: sequence chunks of
    ``x`` [batch, seq, hidden] against the head weight, so at most about
    ``chunk_tokens`` x vocab f32 logits are live at once. Each chunk is
    recomputed in the backward, so the same bound holds for gradients.

    The loss is the NLL sum over the token (or mask) count. With a
    ``mesh`` the rows (and under ``context`` the sequence) are this rank's
    share of the batch, and the count is the whole batch's, as JAX divides
    a sharded batch's sum by its global count: the ranks' shares sum to
    the loss. Under ``model``, ``w`` is this rank's vocab block and the
    loss is every model rank's alike."""
    b, s, _ = x.shape
    mask_f = None if mask is None else mask.float()
    if mesh is not None:
        x = mesh.to_model(x)
    nc = loss_chunks(b, s, chunk_tokens)
    if nc == 1:
        nll = _chunk_nll(x, w, labels, vocab_major, mesh)
        if mask_f is None:
            total, count = nll.sum(), torch.full((), float(nll.numel()), device=x.device)
        else:
            total, count = (nll * mask_f).sum(), mask_f.sum()
        if mesh is not None:
            count = mesh.batch_count(count)
        return total / torch.clamp(count, min=1.0)

    def body(xc, lc, mc):
        return (_chunk_nll(xc, w, lc, vocab_major, mesh) * mc).sum()

    cs = s // nc
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(nc):
        cols = slice(c * cs, (c + 1) * cs)
        mc = (torch.ones(b, cs, dtype=torch.float32, device=x.device)
              if mask_f is None else mask_f[:, cols])
        total = total + _ckpt(body, x[:, cols], labels[:, cols], mc)
        count = count + mc.sum()
    if mesh is not None:
        count = mesh.batch_count(count)
    return total / torch.clamp(count, min=1.0)
