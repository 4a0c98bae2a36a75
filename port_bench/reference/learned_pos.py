"""The plain forward of the port's learned-position transformer, which
``bert.py`` and ``gpt2.py`` train through ``core.py``: PyTorch in float32,
nothing of the program.

It follows the port's stated architecture: token and learned position
embeddings; per layer a pre-LayerNorm attention block (q, k, v and o
projections with biases, softmax attention, causal or not) and a
pre-LayerNorm MLP (GELU, tanh approximation), each added to the residual; a
final LayerNorm; the head tied to the token table.
"""

from __future__ import annotations

import math

import torch


class Model:
    """The forward and loss of one block of rows (``core.py``'s model)."""

    def __init__(self, cfg: dict, causal: bool):
        self.h, self.L = cfg["hidden_size"], cfg["num_hidden_layers"]
        self.n = cfg["num_attention_heads"]
        self.d = self.h // self.n
        self.eps = float(cfg["layer_norm_eps"])
        self.causal = causal

    def ln(self, x, scale, bias):
        mean = x.mean(dim=-1, keepdim=True)
        var = (x - mean).square().mean(dim=-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + self.eps) * scale + bias

    @staticmethod
    def gelu(x):
        return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))

    def attend(self, q, k, v, mm):
        """q, k, v [rows, heads, S, d] -> [rows, S, heads * d]."""
        rows, n, s, d = q.shape
        scores = mm(q, k.transpose(-1, -2)) / math.sqrt(d)
        if self.causal:
            keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
            scores = scores.masked_fill(~keep, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        return mm(probs, v).transpose(1, 2).reshape(rows, s, n * d)

    def block(self, p: dict, inputs, labels, weight, mm, stats):
        """(sum of ``weight`` x the token cross entropy over a block, no
        microbatch term)."""
        rows, s = inputs.shape
        h, n, d = self.h, self.n, self.d
        x = p["embed/tokens"][inputs] + p["embed/pos"][:s]
        for i in range(self.L):
            y = self.ln(x, p["layers/attn_norm/scale"][i], p["layers/attn_norm/bias"][i])

            def heads(w, b):
                out = mm(y, w[i].reshape(h, n * d)) + b[i].reshape(n * d)
                return out.view(rows, s, n, d).transpose(1, 2)

            o = self.attend(heads(p["layers/attn/wq"], p["layers/attn/bq"]),
                            heads(p["layers/attn/wk"], p["layers/attn/bk"]),
                            heads(p["layers/attn/wv"], p["layers/attn/bv"]), mm)
            x = x + mm(o, p["layers/attn/wo"][i].reshape(n * d, h)) + p["layers/attn/bo"][i]
            y = self.ln(x, p["layers/mlp_norm/scale"][i], p["layers/mlp_norm/bias"][i])
            mid = self.gelu(mm(y, p["layers/mlp/wi"][i]) + p["layers/mlp/bi"][i])
            x = x + mm(mid, p["layers/mlp/wo"][i]) + p["layers/mlp/bo"][i]
        x = self.ln(x, p["final_norm/scale"], p["final_norm/bias"])
        if weight is None:
            hid, gold, w = x.reshape(rows * s, h), labels.reshape(-1), None
        else:
            # only the positions the loss reads need the head
            at = weight.reshape(-1) > 0
            hid, gold, w = x.reshape(rows * s, h)[at], labels.reshape(-1)[at], \
                weight.reshape(-1)[at]
        logits = mm(hid, p["embed/tokens"].t())
        nll = torch.logsumexp(logits, dim=-1) - logits.gather(1, gold[:, None])[:, 0]
        return (nll.sum() if w is None else (nll * w).sum()), None
