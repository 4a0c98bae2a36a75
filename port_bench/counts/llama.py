"""Operations and bytes of a training step of the port's Llama family
(GQA, SwiGLU, an untied head), from the configuration file's sizes and the
cell's shapes.

What is counted is what the inputs need, once, whatever the program runs:

- the projections at every token: q and o over the query heads, k and v
  over the kv heads (GQA), SwiGLU's three matrices; the untied head at the
  positions the loss reads (every one for next-token traffic); forward and
  backward as three times the forward;
- attention's two products (QK^T and PV) over the (query, key) pairs the
  mask leaves visible, S(S+1)/2 a row and query head under the causal mask,
  three times the forward;
- nothing for norms, RoPE, activations, the loss's reductions or the
  optimizer, and nothing recomputed.

The flash kernels' work is the learned-position transformer's
(``transformer.py``): the port expands k and v to the query heads
(``ops/attention.py``'s ``repeat_kv``) before its flash kernels, which so
read q, k and v alike over every query head, one forward, one dQ and one
dK/dV launch a layer and microbatch.
"""

from __future__ import annotations

from port_bench.counts.transformer import flash_launch_work, flash_least_s  # noqa: F401


def step_flops(cfg: dict, batch_size: int, seq_len: int, loss_tokens: int) -> dict:
    """``{"model": ..., "matmul": ...}`` FLOPs of one step (forward and
    backward) over ``batch_size x seq_len`` tokens, ``loss_tokens`` of
    which the loss reads."""
    h, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    n, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    d, m, V = h // n, cfg["intermediate_size"], cfg["vocab_size"]
    tokens = batch_size * seq_len
    projections = 2 * tokens * L * (2 * h * n * d + 2 * h * kv * d + 3 * h * m)
    head = 2 * loss_tokens * h * V
    visible = seq_len * (seq_len + 1) // 2 if cfg["causal"] else seq_len * seq_len
    pairs = batch_size * n * visible
    attention = 2 * 2 * pairs * d * L
    return {"model": 3 * (projections + head + attention), "matmul": 3 * (projections + head)}
