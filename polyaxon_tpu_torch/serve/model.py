"""Decode-mode transformer over the paged KV cache — port of
``polyaxon_tpu/serve/model.py``.

Three entry points over ``(params, pools)``:

- :func:`prefill_chunk` — a chunk of one request's prompt: writes the
  chunk's K/V into pre-allocated blocks and attends causally over the
  cached prefix + the chunk itself.
- :func:`decode_step` — one token for every running slot, batched: cache
  write + paged attention (``impl="gather"`` or the ``"flash"`` CUDA
  kernel, ``ops/paged_attention.py``).
- :func:`verify_step` — speculative decoding's target step: a window of
  S tokens for every running slot, batched (gathered blocks and dense f32
  products, as the JAX package computes it outside any kernel).

Where the JAX functions donate the pools and return new ones, these write
the pools in place (``index_put_``) and return only the logits. The math
follows the JAX package step for step (same norm / projection / rope /
activation order, f32 softmax), eagerly, one layer at a time. Prefill
attention and every projection are ``torch.einsum``/``matmul``, as the JAX
package leaves them to XLA.
"""

from __future__ import annotations

import torch

from ..models.transformer import TransformerConfig, _norm, head_weights
from ..ops.layers import apply_rope, gelu, rope_frequencies, swiglu
from ..ops.paged_attention import gather_blocks, paged_attention
from .kv_cache import PagedKVCache

#: matrix weights a serving replica keeps in the activation dtype
_MATRIX_LEAVES = ("wq", "wk", "wv", "wo", "wi", "wg", "tokens", "pos", "w")


def init_cache(cfg: TransformerConfig, num_blocks: int, block_size: int,
               enable_prefix_cache: bool = True, *,
               device) -> PagedKVCache:
    return PagedKVCache(
        num_layers=cfg.num_layers, num_blocks=num_blocks,
        block_size=block_size, kv_heads=cfg.kv_heads, head_dim=cfg.hd,
        dtype=cfg.dtype,
        enable_prefix_cache=enable_prefix_cache, device=device)


def serving_params(params: dict, cfg: TransformerConfig) -> dict:
    """Cast the matrix weights to the activation dtype once. The layer
    math casts each weight to ``cfg.dtype`` before its product (as the JAX
    package does inside jit); doing it up front gives the same values and
    saves a full read and write of the f32 weights on every step. Norm
    scales and biases stay as they are (the norms read them in f32)."""
    def cast(tree, name=None):
        if isinstance(tree, dict):
            return {k: cast(v, k) for k, v in tree.items()}
        return tree.to(cfg.dtype) if name in _MATRIX_LEAVES else tree
    return cast(params)


def _layer(params: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked ``[L, ...]`` layer params."""
    def take(tree):
        if isinstance(tree, dict):
            return {k: take(v) for k, v in tree.items()}
        return tree[i]
    return take(params["layers"])


def _layer_qkv(x, lp, cfg: TransformerConfig, rope_tables, positions):
    """Projections + rope for a [B, S, h] slice at per-row ``positions``
    [B, S]."""
    dt = cfg.dtype
    ap = lp["attn"]
    y = _norm(x, lp["attn_norm"], cfg)
    q = torch.einsum("bsh,hnd->bnsd", y, ap["wq"].to(dt))
    k = torch.einsum("bsh,hnd->bnsd", y, ap["wk"].to(dt))
    v = torch.einsum("bsh,hnd->bnsd", y, ap["wv"].to(dt))
    if cfg.use_bias:
        q = q + ap["bq"].to(dt)[None, :, None, :]
        k = k + ap["bk"].to(dt)[None, :, None, :]
        v = v + ap["bv"].to(dt)[None, :, None, :]
    if cfg.pos == "rope":
        cos, sin = rope_tables
        q = apply_rope(q, cos, sin, positions=positions)
        k = apply_rope(k, cos, sin, positions=positions)
    return q, k, v


def _layer_mlp(x, o, lp, cfg: TransformerConfig):
    """Residual + MLP half of the layer. The serving model has no
    mixture-of-experts branch (nor has the JAX package's): an expert stack
    raises here instead of broadcasting through ``torch.matmul``."""
    dt = cfg.dtype
    ap, mp = lp["attn"], lp["mlp"]
    if "router" in mp:
        raise ValueError(
            f"the serving model has no mixture-of-experts branch: its MLP reads one "
            f"dense [hidden, mlp] weight, and this layer holds {cfg.num_experts} experts "
            f"behind a router")
    h = x.shape[-1]
    o = torch.matmul(o, ap["wo"].to(dt).reshape(-1, h))
    if cfg.use_bias:
        o = o + ap["bo"].to(dt)
    x = x + o
    y = _norm(x, lp["mlp_norm"], cfg)
    if cfg.act == "swiglu":
        hidden = swiglu(torch.matmul(y, mp["wi"].to(dt)),
                        torch.matmul(y, mp["wg"].to(dt)))
    else:
        hidden = torch.matmul(y, mp["wi"].to(dt))
        if cfg.use_bias:
            hidden = hidden + mp["bi"].to(dt)
        hidden = gelu(hidden)
    out = torch.matmul(hidden, mp["wo"].to(dt))
    if cfg.use_bias:
        out = out + mp["bo"].to(dt)
    return x + out


def _write_kv(pool_l, vals, blk, slot):
    """Scatter [B, S] token rows into one layer's pool in place:
    ``pool_l[blk, slot] <- vals``. ``blk`` already routes masked rows to
    the trash block, so live indices are unique (sequences own disjoint
    blocks past their shared prefix)."""
    b, s, kvh, d = vals.shape
    pool_l.index_put_((blk.reshape(-1), slot.reshape(-1)),
                      vals.reshape(b * s, kvh, d).to(pool_l.dtype))


def _write_coords(cache_positions, block_tables, block_size, write_mask,
                  trash_block):
    """(block id, slot) for each [B, S] cache position; masked positions
    go to the trash block."""
    blk_idx = (cache_positions // block_size).clamp(0, block_tables.shape[1] - 1)
    blk = torch.take_along_dim(block_tables.long(), blk_idx, dim=1)
    blk = torch.where(write_mask, blk, torch.full_like(blk, trash_block))
    slot = cache_positions % block_size
    return blk, slot


def _regroup(q, kv_heads):
    """[B, H, S, D] -> [B, KVH, G, S, D] (query heads grouped per KV head,
    matching the paged-attention GQA layout)."""
    b, h, s, d = q.shape
    return q.reshape(b, kv_heads, h // kv_heads, s, d)


def _rope_tables(cfg: TransformerConfig, device):
    if cfg.pos != "rope":
        return None
    return rope_frequencies(cfg.hd, cfg.max_seq, cfg.rope_theta, device=device)


def _logits(params, hidden, cfg: TransformerConfig):
    w, vocab_major = head_weights(params, cfg)
    w = w.to(cfg.dtype)
    return torch.matmul(hidden, w.t() if vocab_major else w).float()


@torch.no_grad()
def decode_step(
    params: dict,
    tokens: torch.Tensor,        # [B] int — this step's input token per slot
    positions: torch.Tensor,     # [B] int — cache position to write (= #cached)
    k_pool: torch.Tensor,        # [L, N+1, bs, KVH, D], written in place
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # [B, T] int32
    active: torch.Tensor,        # [B] bool
    *,
    cfg: TransformerConfig,
    impl: str = "gather",
) -> torch.Tensor:
    """One batched decode iteration. Writes this step's K/V into the pools
    in place and returns logits [B, V] f32. Inactive slots write to the
    trash block and come back with garbage logits the engine never reads."""
    dt = cfg.dtype
    dev = k_pool.device
    block_size = k_pool.shape[2]
    tokens = tokens.to(dev).long()
    positions = positions.to(dev).long()
    active = active.to(dev)
    block_tables = block_tables.to(dev)
    x = params["embed"]["tokens"].to(dt)[tokens][:, None, :]       # [B,1,h]
    rope_tables = _rope_tables(cfg, dev)
    pos_safe = positions.clamp(0, cfg.max_seq - 1)[:, None]        # [B,1]
    if cfg.pos == "learned":
        x = x + params["embed"]["pos"].to(dt)[pos_safe[:, 0]][:, None, :]
    lengths = torch.where(active, positions + 1,
                          torch.zeros_like(positions)).to(torch.int32)
    blk, slot = _write_coords(pos_safe, block_tables, block_size,
                              active[:, None], k_pool.shape[1] - 1)
    tables32 = block_tables.to(torch.int32).contiguous()

    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        q, k, v = _layer_qkv(x, lp, cfg, rope_tables, pos_safe)
        _write_kv(k_pool[i], k.transpose(1, 2), blk, slot)
        _write_kv(v_pool[i], v.transpose(1, 2), blk, slot)
        qg = _regroup(q, cfg.kv_heads)[:, :, :, 0, :].contiguous()  # [B,KVH,G,D]
        o = paged_attention(qg, k_pool[i], v_pool[i], tables32, lengths,
                            impl=impl)
        b, kvh, g, d = o.shape
        o = o.reshape(b, 1, kvh * g * d).to(dt)
        x = _layer_mlp(x, o, lp, cfg)
    hidden = _norm(x, params["final_norm"], cfg)[:, 0, :]          # [B, h]
    return _logits(params, hidden, cfg)


@torch.no_grad()
def prefill_chunk(
    params: dict,
    tokens: torch.Tensor,        # [1, C] int — chunk of ONE request's prompt
    start: int,                  # cache position of tokens[0, 0]
    chunk_len: int,              # live tokens in this chunk
    k_pool: torch.Tensor,        # written in place
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # [1, T] int32
    *,
    cfg: TransformerConfig,
) -> torch.Tensor:
    """Prefill one chunk of a prompt: write its K/V in place and attend
    causally over cached prefix + chunk. Returns last_logits [1, V] f32 —
    the next-token distribution after the final LIVE chunk position (only
    meaningful on the prompt's last chunk)."""
    dt = cfg.dtype
    dev = k_pool.device
    block_size = k_pool.shape[2]
    tokens = tokens.to(dev).long()
    block_tables = block_tables.to(dev)
    c = tokens.shape[1]
    start, chunk_len = int(start), int(chunk_len)
    offs = torch.arange(c, device=dev)
    positions = start + offs[None, :]                               # [1, C]
    live = offs[None, :] < chunk_len                                # [1, C]
    pos_safe = torch.where(live, positions, torch.zeros_like(positions))
    pos_safe = pos_safe.clamp(0, cfg.max_seq - 1)
    x = params["embed"]["tokens"].to(dt)[tokens]
    if cfg.pos == "learned":
        x = x + params["embed"]["pos"].to(dt)[pos_safe[0]][None]
    rope_tables = _rope_tables(cfg, dev)
    blk, slot = _write_coords(pos_safe, block_tables, block_size, live,
                              k_pool.shape[1] - 1)
    capacity = block_tables.shape[1] * block_size
    k_ids = torch.arange(capacity, device=dev)
    mask = k_ids[None, None, :] <= positions[..., None]             # [1, C, C_cap]
    scale = cfg.hd ** -0.5

    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        q, k, v = _layer_qkv(x, lp, cfg, rope_tables, pos_safe)
        _write_kv(k_pool[i], k.transpose(1, 2), blk, slot)
        _write_kv(v_pool[i], v.transpose(1, 2), blk, slot)
        kc = gather_blocks(k_pool[i], block_tables)                 # [1,C_cap,KVH,D]
        vc = gather_blocks(v_pool[i], block_tables)
        qg = _regroup(q, cfg.kv_heads)                              # [1,KVH,G,C,D]
        scores = torch.einsum("bhgsd,bchd->bhgsc", qg.float(),
                              kc.float()) * scale
        scores = scores.masked_fill(~mask[:, None, None, :, :], float("-inf"))
        probs = torch.nan_to_num(torch.softmax(scores, dim=-1), nan=0.0)
        o = torch.einsum("bhgsc,bchd->bhgsd", probs, vc.float()).to(dt)
        b, kvh, g, s, d = o.shape
        o = o.reshape(b, kvh * g, s, d).transpose(1, 2).reshape(b, s, kvh * g * d)
        x = _layer_mlp(x, o, lp, cfg)
    hidden = _norm(x, params["final_norm"], cfg)                    # [1, C, h]
    last = min(max(chunk_len - 1, 0), c - 1)
    return _logits(params, hidden[:, last, :], cfg)


@torch.no_grad()
def verify_step(
    params: dict,
    tokens: torch.Tensor,        # [B, S] int — pending token + S-1 proposals
    positions: torch.Tensor,     # [B] int — cache position of tokens[:, 0]
    k_pool: torch.Tensor,        # written in place
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # [B, T] int32
    active: torch.Tensor,        # [B] bool
    *,
    cfg: TransformerConfig,
) -> torch.Tensor:
    """Speculative VERIFY: the target model scores a draft's S-token
    window (pending token + S-1 proposals) per running row in one batched
    multi-token step. Returns logits [B, S, V] f32: ``logits[:, j]`` is
    the next-token distribution after ``tokens[:, j]``, the same layer
    math as :func:`decode_step` at that position.

    All S positions' K/V are written in place (inactive rows to the trash
    block); the engine advances ``seq.length`` only over the ACCEPTED
    prefix, so rejected positions are masked garbage the next step
    overwrites. Attention is the JAX package's: gathered blocks and a
    dense f32 product, NaN rows (a row that sees no key) set to 0."""
    dt = cfg.dtype
    dev = k_pool.device
    block_size = k_pool.shape[2]
    tokens = tokens.to(dev).long()
    positions = positions.to(dev).long()
    active = active.to(dev)
    block_tables = block_tables.to(dev)
    b, s = tokens.shape
    offs = torch.arange(s, device=dev)
    positions_2d = positions[:, None] + offs[None, :]               # [B, S]
    live = active[:, None].expand(b, s)
    pos_safe = positions_2d.clamp(0, cfg.max_seq - 1)
    x = params["embed"]["tokens"].to(dt)[tokens]                    # [B, S, h]
    if cfg.pos == "learned":
        x = x + params["embed"]["pos"].to(dt)[pos_safe]
    rope_tables = _rope_tables(cfg, dev)
    blk, slot = _write_coords(pos_safe, block_tables, block_size, live,
                              k_pool.shape[1] - 1)
    capacity = block_tables.shape[1] * block_size
    k_ids = torch.arange(capacity, device=dev)
    mask = k_ids[None, None, :] <= positions_2d[..., None]          # [B, S, C_cap]
    scale = cfg.hd ** -0.5

    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        q, k, v = _layer_qkv(x, lp, cfg, rope_tables, pos_safe)
        _write_kv(k_pool[i], k.transpose(1, 2), blk, slot)
        _write_kv(v_pool[i], v.transpose(1, 2), blk, slot)
        kc = gather_blocks(k_pool[i], block_tables)                 # [B,C_cap,KVH,D]
        vc = gather_blocks(v_pool[i], block_tables)
        kvh, d = cfg.kv_heads, cfg.hd
        g = cfg.num_heads // kvh
        # a KV head's G query heads x S positions as the rows of one product
        # (a broadcast over G would copy the gathered cache G times)
        qg = _regroup(q, kvh).reshape(b, kvh, g * s, d)             # [B,KVH,G*S,D]
        scores = torch.matmul(qg.float(), kc.float().permute(0, 2, 3, 1)) * scale
        scores = scores.reshape(b, kvh, g, s, capacity)
        scores = scores.masked_fill(~mask[:, None, None, :, :], float("-inf"))
        probs = torch.nan_to_num(torch.softmax(scores, dim=-1), nan=0.0)
        o = torch.matmul(probs.reshape(b, kvh, g * s, capacity),
                         vc.float().permute(0, 2, 1, 3)).to(dt)     # [B,KVH,G*S,D]
        o = o.reshape(b, kvh * g, s, d).transpose(1, 2).reshape(b, s, kvh * g * d)
        x = _layer_mlp(x, o, lp, cfg)
    hidden = _norm(x, params["final_norm"], cfg)                    # [B, S, h]
    return _logits(params, hidden, cfg)


def extend_with_identity_layers(params: dict, cfg: TransformerConfig,
                                extra_layers: int):
    """A target model that provably agrees with its draft: append
    ``extra_layers`` IDENTITY layers (copies of the last layer with the
    attention and MLP output projections — and their biases — zeroed, so
    each appended layer is ``x -> x + 0 + 0``) to the stacked ``params``.
    The extended model's logits equal the original's while it costs
    ``(L + extra) / L`` the compute — the speculative fixture with 100%
    draft agreement by construction. Returns (params, cfg)."""
    from dataclasses import replace

    zeroed = {("attn", "wo"), ("attn", "bo"), ("mlp", "wo"), ("mlp", "bo")}

    def extend(tree, path=()):
        if isinstance(tree, dict):
            return {k: extend(v, path + (k,)) for k, v in tree.items()}
        tail = tree[-1:].expand(extra_layers, *tree.shape[1:])
        if path[-2:] in zeroed:
            tail = torch.zeros_like(tail)
        return torch.cat([tree, tail], dim=0)

    out = dict(params)
    out["layers"] = extend(params["layers"])
    return out, replace(cfg, num_layers=cfg.num_layers + extra_layers)


def dense_reference_decode(params, cfg: TransformerConfig, prompts,
                           max_new_tokens: int, sample_fn=None):
    """Contiguous-cache decode oracle: the same layer math over a
    per-sequence dense [C] cache (one block spanning the whole capacity,
    no paging), on the params' device. Greedy by default. Returns
    list[list[int]] per prompt."""
    from .kv_cache import SequenceBlocks

    device = params["embed"]["tokens"].device
    max_len = max(len(p) for p in prompts) + max_new_tokens
    outs = []
    for prompt in prompts:
        cache = init_cache(cfg, num_blocks=1, block_size=max_len,
                           device=device)
        seq = SequenceBlocks()
        cache.ensure(seq, len(prompt) + max_new_tokens)
        tables = torch.as_tensor(cache.block_table_array([seq], 1),
                                 device=device)
        logits = prefill_chunk(
            params, torch.tensor([prompt], device=device), 0, len(prompt),
            cache.k, cache.v, tables, cfg=cfg)
        gen = []
        pos = len(prompt)
        for _ in range(max_new_tokens):
            arr = logits[0].cpu().numpy()
            tok = int(arr.argmax()) if sample_fn is None else sample_fn(arr)
            gen.append(tok)
            if len(gen) == max_new_tokens:
                break
            logits = decode_step(
                params, torch.tensor([tok], device=device),
                torch.tensor([pos], device=device), cache.k, cache.v, tables,
                torch.tensor([True], device=device), cfg=cfg)
            pos += 1
        outs.append(gen)
    return outs
