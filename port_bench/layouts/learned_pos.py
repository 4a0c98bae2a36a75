"""The layout of the port's learned-position transformer (BERT, GPT-2):
token and position tables, LayerNorm with biases, q/k/v/o and the two MLP
matrices with biases, the head tied to the token table.

Weights at sigma 0.02, the residual output projections at 0.02 / sqrt(2L),
biases at 0.02 (not zero, so that a dropped bias shows), norm scales at
1 + 0.1 N.
"""

from __future__ import annotations

import math


def layout(cfg: dict) -> list[tuple[str, tuple, float, float, bool]]:
    h, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    n = cfg["num_attention_heads"]
    d, m = h // n, cfg["intermediate_size"]
    V, P = cfg["vocab_size"], cfg["max_position_embeddings"]
    w, out = 0.02, 0.02 / math.sqrt(2 * L)
    leaves = {
        "embed/tokens": ((V, h), w, 0.0),
        "embed/pos": ((P, h), w, 0.0),
        "final_norm/scale": ((h,), 0.1, 1.0),
        "final_norm/bias": ((h,), w, 0.0),
        "layers/attn_norm/scale": ((L, h), 0.1, 1.0),
        "layers/attn_norm/bias": ((L, h), w, 0.0),
        "layers/mlp_norm/scale": ((L, h), 0.1, 1.0),
        "layers/mlp_norm/bias": ((L, h), w, 0.0),
        "layers/attn/wq": ((L, h, n, d), w, 0.0),
        "layers/attn/wk": ((L, h, n, d), w, 0.0),
        "layers/attn/wv": ((L, h, n, d), w, 0.0),
        "layers/attn/wo": ((L, n, d, h), out, 0.0),
        "layers/attn/bq": ((L, n, d), w, 0.0),
        "layers/attn/bk": ((L, n, d), w, 0.0),
        "layers/attn/bv": ((L, n, d), w, 0.0),
        "layers/attn/bo": ((L, h), w, 0.0),
        "layers/mlp/wi": ((L, h, m), w, 0.0),
        "layers/mlp/wo": ((L, m, h), out, 0.0),
        "layers/mlp/bi": ((L, m), w, 0.0),
        "layers/mlp/bo": ((L, h), w, 0.0),
    }
    return [(path, *leaf, path.startswith("layers/")) for path, leaf in leaves.items()]


def stated(m) -> dict:
    """The program's ``TransformerConfig`` under the configuration file's
    keys."""
    return {"vocab_size": m.vocab_size, "hidden_size": m.hidden,
            "num_hidden_layers": m.num_layers, "num_attention_heads": m.num_heads,
            "intermediate_size": m.mlp_dim, "max_position_embeddings": m.max_seq,
            "layer_norm_eps": m.eps, "causal": m.causal,
            "activation_dtype": str(m.dtype).removeprefix("torch."),
            "param_dtype": str(m.param_dtype).removeprefix("torch.")}
