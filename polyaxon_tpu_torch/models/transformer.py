"""Transformer config, parameter layout, init and the training forward
of the port.

Counterpart of ``polyaxon_tpu/models/transformer.py`` for dense models:
the config, the parameter tree (the same nested-dict layout with
layer-stacked ``[L, ...]`` leaves, so weights carry across unchanged), the
init law, the layer body with its remat policies, ``apply_hidden``/``apply``
and the (chunked) LM loss. Parameters are a plain nested dict of tensors.
The decode-mode layer loop of the serving path lives in ``serve/model.py``.

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
  ring) or Ulysses (``"ulysses"``, kv expanded first).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from ..ops.attention import attention, repeat_kv
from ..ops.layers import apply_rope, gelu, layer_norm, rms_norm, rope_frequencies, swiglu
from ..ops.ring_attention import ring_attention
from ..ops.ulysses import ulysses_attention
from ..parallel.fsdp import fresh
from ..parallel.mesh import ShardingRules


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

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def hd(self) -> int:
        return self.head_dim or self.hidden // self.num_heads

    def flops_per_token(self, seq_len: int) -> float:
        """Approximate training FLOPs/token (fwd+bwd = 6N + attention
        term); feeds the MFU meter."""
        attn = 12 * self.num_layers * self.hidden * seq_len  # qk+av fwd+bwd
        return 6 * self.active_params() + attn

    def active_params(self) -> int:
        """Params touched per token; every param, for a dense model."""
        return self.num_params()

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


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------


def _qkv(x, lp, cfg: TransformerConfig, rope_tables, mesh=None):
    """Norm, q/k/v projections and rope: [b, s, h] -> three [b, n, s, d]
    (under ``model``, n is the rank's heads: column-parallel)."""
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


def _attend(q, k, v, cfg: TransformerConfig, mesh=None):
    """GQA attention (causal or not, as ``cfg.causal`` says), heads merged:
    [b, s, n*d] (the JAX package's ``attn_out`` save). With a ``context``
    axis the sequence is cut over ranks (``_sharded_attention``'s
    dispatch): ring attention keeps the kv heads compact; Ulysses expands
    them first."""
    b, n, s, d = q.shape
    cp = mesh.cp if mesh is not None else 1
    if cp > 1 and cfg.seq_parallel == "ring":
        o = ring_attention(q, k, v, exchange=mesh.ring(), causal=cfg.causal,
                           block_q=min(cfg.attn_block_q, s),
                           block_k=min(cfg.attn_block_k, k.shape[2]))
    elif cp > 1:
        o = ulysses_attention(q, repeat_kv(k, n), repeat_kv(v, n),
                              group=mesh.group("context"), size=cp, causal=cfg.causal,
                              impl=cfg.attn_impl)
    else:
        o = attention(q, k, v, causal=cfg.causal, impl=cfg.attn_impl,
                      block_q=min(cfg.attn_block_q, s),
                      block_k=min(cfg.attn_block_k, k.shape[2]),
                      block_q_bwd=cfg.attn_block_q_bwd or None,
                      block_k_bwd=cfg.attn_block_k_bwd or None)
    return o.transpose(1, 2).reshape(b, s, n * d)


def _row_parallel(y, w, bias, mesh):
    """``y @ w`` whose contracted dim is cut over model: each rank's partial
    product, summed over model, then ``bias`` once (added before the sum,
    a replicated bias would count once per rank)."""
    out = torch.matmul(y, w)
    if mesh is not None:
        out = mesh.from_model(out)
    return out if bias is None else out + bias


def _out_mlp(x, o, lp, cfg: TransformerConfig, mesh=None):
    """Out projection, residual, norm, MLP, residual (under ``model``: the
    MLP's columns this rank's, both out projections row-parallel)."""
    dt = cfg.dtype
    ap, mp = lp["attn"], lp["mlp"]
    h = x.shape[-1]
    bias = (lambda t: t.to(dt)) if cfg.use_bias else (lambda t: None)  # noqa: E731
    o = _row_parallel(o, ap["wo"].to(dt).reshape(-1, h), bias(ap.get("bo")), mesh)
    x = x + o
    y = _norm(x, lp["mlp_norm"], cfg)
    if mesh is not None:
        y = mesh.to_model(y)
    if cfg.act == "swiglu":
        hidden = swiglu(torch.matmul(y, mp["wi"].to(dt)), torch.matmul(y, mp["wg"].to(dt)))
    else:
        hidden = torch.matmul(y, mp["wi"].to(dt))
        if cfg.use_bias:
            hidden = hidden + mp["bi"].to(dt)
        hidden = gelu(hidden)
    return x + _row_parallel(hidden, mp["wo"].to(dt), bias(mp.get("bo")), mesh)


def _layer_body(x, lp, cfg: TransformerConfig, rope_tables, mesh=None):
    """One transformer layer, no remat."""
    return _out_mlp(x, _attend(*_qkv(x, lp, cfg, rope_tables, mesh), cfg, mesh), lp, cfg,
                    mesh)


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the outputs of matrix products without batch dimensions (the
    projections' ``torch.matmul`` folds to ``aten.mm``), recompute the rest."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _ckpt(fn, *args, **kwargs):
    return checkpoint(fn, *args, use_reentrant=False, **kwargs)


def _remat_layer(x, lp, cfg: TransformerConfig, rope_tables, mesh=None):
    """One layer under ``cfg.remat``. Each policy keeps for the backward
    what the JAX policy saves and recomputes the rest (the layer input is
    always kept, as the scan carry is):

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
    if cfg.remat == "none":
        return _layer_body(x, lp, cfg, rope_tables, mesh)
    if cfg.remat == "full":
        return _ckpt(lambda x: _layer_body(x, fresh(lp), cfg, rope_tables, mesh), x)
    if cfg.remat == "attn":
        o = _ckpt(lambda x: _attend(*_qkv(x, fresh(lp), cfg, rope_tables, mesh), cfg, mesh),
                  x)
        return _ckpt(lambda x, o: _out_mlp(x, o, fresh(lp), cfg, mesh), x, o)
    if cfg.remat == "attn_qkv":
        q, k, v = _ckpt(lambda x: _qkv(x, fresh(lp), cfg, rope_tables, mesh), x)
        o = _ckpt(lambda q, k, v: _attend(q, k, v, cfg, mesh), q, k, v)
        return _ckpt(lambda x, o: _out_mlp(x, o, fresh(lp), cfg, mesh), x, o)
    if cfg.remat == "dots":
        return _ckpt(lambda x: _layer_body(x, fresh(lp), cfg, rope_tables, mesh), x,
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


def run_trunk(x: torch.Tensor, layers: dict, cfg: TransformerConfig,
              rope_tables=None, mesh=None) -> torch.Tensor:
    """The stacked layers over ``x`` [batch, seq, hidden] under
    ``cfg.remat``; shared by :func:`apply_hidden` and encoder-only models
    (ViT). fsdp shards (a ``ShardedTree``) unstack into per-layer views
    that gather each layer's params when it runs."""
    unstack = getattr(layers, "unstack", None)
    per_layer = unstack(cfg.num_layers) if unstack else _unstack(layers, cfg.num_layers)
    for lp in per_layer:
        x = _remat_layer(x, lp, cfg, rope_tables, mesh)
    return x


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
                 inputs_embeds: Optional[torch.Tensor] = None, mesh=None) -> torch.Tensor:
    """Trunk forward: tokens [batch, seq] -> final-norm hidden states
    [batch, seq, hidden] in the activation dtype. ``inputs_embeds``
    [batch, seq, hidden] takes the place of the token embedding. The vocab
    projection is left to the caller (the training loss fuses it
    blockwise). With ``mesh``, seq is this rank's chunk of the sequence,
    positioned at its global offset."""
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
    x = run_trunk(x, params["layers"], cfg, rope_tables, mesh)
    return _norm(x, params["final_norm"], cfg)


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
