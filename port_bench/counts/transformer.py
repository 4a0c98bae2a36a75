"""Operations and bytes of a training step of the learned-position
transformer (BERT, GPT-2), from the configuration file's sizes and the
cell's shapes.

What is counted is what the inputs need, once, whatever the program runs:

- the projections (q, k, v, o and the two MLP matrices) at every token, and
  the tied head only at the positions the loss reads (the masked ones for
  MLM), forward and backward as three times the forward;
- attention's two products (QK^T and PV) over the (query, key) pairs the
  mask leaves visible: all of them, or S(S+1)/2 a row and head under the
  causal mask, three times the forward;
- nothing for norms, activations, the loss's reductions or the optimizer,
  and nothing recomputed.

The step's model FLOPs (``step_mfu``) are all of it; the matrix products
(``gemm_roofline``) are the projections and the head. The flash kernels'
least times are the port's flash counts (each input byte read once, each
output byte written once; the products over the visible pairs), per launch
as ``bh = rows x heads`` of one microbatch, one forward, one dQ and one dK/dV
launch a layer and microbatch.
"""

from __future__ import annotations


def _visible_pairs(seq_len: int, causal: bool) -> int:
    return seq_len * (seq_len + 1) // 2 if causal else seq_len * seq_len


def step_flops(cfg: dict, batch_size: int, seq_len: int, loss_tokens: int) -> dict:
    """``{"model": ..., "matmul": ...}`` FLOPs of one step (forward and
    backward) over ``batch_size x seq_len`` tokens, ``loss_tokens`` of
    which the loss reads."""
    h, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    m, V = cfg["intermediate_size"], cfg["vocab_size"]
    tokens = batch_size * seq_len
    projections = 2 * tokens * L * (4 * h * h + 2 * h * m)
    head = 2 * loss_tokens * h * V
    pairs = batch_size * cfg["num_attention_heads"] * _visible_pairs(seq_len, cfg["causal"])
    attention = 2 * 2 * pairs * (h // cfg["num_attention_heads"]) * L
    return {"model": 3 * (projections + head + attention), "matmul": 3 * (projections + head)}


def flash_launch_work(cfg: dict, batch_size: int, seq_len: int,
                      microbatches: int, esize: int = 2) -> dict:
    """Per step: ``{kernel: (launches, FLOPs, bytes)}`` of the flash
    forward, dQ and dK/dV kernels (``esize``: bytes of an element of q, k,
    v and o)."""
    n, L = cfg["num_attention_heads"], cfg["num_hidden_layers"]
    d = cfg["hidden_size"] // n
    bh = batch_size // microbatches * n
    per_product = 2 * d * _visible_pairs(seq_len, cfg["causal"]) * bh
    rows = keys = bh * seq_len * d * esize
    stats = bh * seq_len * 4
    launches = L * microbatches
    work = {
        "flash_fwd": (2 * per_product, 2 * rows + 2 * keys + stats),
        "flash_bwd_dq": (3 * per_product, 3 * rows + 2 * keys + 2 * stats),
        "flash_bwd_dkv": (4 * per_product, 2 * rows + 4 * keys + 2 * stats),
    }
    return {k: (launches, launches * f, launches * b) for k, (f, b) in work.items()}


def flash_least_s(cfg: dict, batch_size: int, seq_len: int, microbatches: int,
                  peaks: dict) -> dict:
    """Per step: the least time of the flash forward (``flash_fwd``) and of
    the two backward kernels together (``flash_bwd``), each launch bound by
    the larger of its FLOPs over the bf16 peak and its bytes over HBM's."""
    out = {"flash_fwd": 0.0, "flash_bwd": 0.0}
    for name, (launches, flops, nbytes) in flash_launch_work(
            cfg, batch_size, seq_len, microbatches).items():
        least = launches * max(flops / launches / peaks["bf16_flops"],
                               nbytes / launches / peaks["hbm_bytes_per_s"])
        out["flash_fwd" if name == "flash_fwd" else "flash_bwd"] += least
    return out
