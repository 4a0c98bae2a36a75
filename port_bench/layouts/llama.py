"""The layout of the port's Llama family (``models/llama.py``): a token
table, RMSNorm scales without biases, grouped-query attention (q over
``num_attention_heads``, k and v over ``num_key_value_heads``, no biases),
SwiGLU's ``wi``, ``wg`` and ``wo``, and an untied head ``lm_head/w``
``[hidden, vocab]``; RoPE, so no position table.

Weights at sigma 0.02, the residual output projections (attention's and the
MLP's ``wo``) at 0.02 / sqrt(2L), norm scales at 1 + 0.1 N.
"""

from __future__ import annotations

import math


def layout(cfg: dict) -> list[tuple[str, tuple, float, float, bool]]:
    h, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    n, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    d, m, V = h // n, cfg["intermediate_size"], cfg["vocab_size"]
    w, out = 0.02, 0.02 / math.sqrt(2 * L)
    leaves = {
        "embed/tokens": ((V, h), w, 0.0),
        "final_norm/scale": ((h,), 0.1, 1.0),
        "lm_head/w": ((h, V), w, 0.0),
        "layers/attn_norm/scale": ((L, h), 0.1, 1.0),
        "layers/mlp_norm/scale": ((L, h), 0.1, 1.0),
        "layers/attn/wq": ((L, h, n, d), w, 0.0),
        "layers/attn/wk": ((L, h, kv, d), w, 0.0),
        "layers/attn/wv": ((L, h, kv, d), w, 0.0),
        "layers/attn/wo": ((L, n, d, h), out, 0.0),
        "layers/mlp/wi": ((L, h, m), w, 0.0),
        "layers/mlp/wg": ((L, h, m), w, 0.0),
        "layers/mlp/wo": ((L, m, h), out, 0.0),
    }
    return [(path, *leaf, path.startswith("layers/")) for path, leaf in leaves.items()]


def stated(m) -> dict:
    """The program's ``TransformerConfig`` under the configuration file's
    keys (``rope_theta`` None where the program runs no RoPE)."""
    return {"vocab_size": m.vocab_size, "hidden_size": m.hidden,
            "num_hidden_layers": m.num_layers, "num_attention_heads": m.num_heads,
            "num_key_value_heads": m.kv_heads, "intermediate_size": m.mlp_dim,
            "max_position_embeddings": m.max_seq, "rms_norm_eps": m.eps,
            "rope_theta": m.rope_theta if m.pos == "rope" else None,
            "tie_word_embeddings": m.tie_embeddings, "causal": m.causal,
            "activation_dtype": str(m.dtype).removeprefix("torch."),
            "param_dtype": str(m.param_dtype).removeprefix("torch.")}
