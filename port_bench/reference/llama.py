"""Plain reference of the port's Llama family (``models/llama.py``): a
causal decoder trained on next-token prediction at every position, through
``core.py``'s step loop. PyTorch in float32 (``core.py`` turns TF32 off);
it imports nothing of the program.

The architecture is the port's: the token embedding, no position table;
per layer RMSNorm (``x / sqrt(mean(x^2) + eps) * scale``, no bias) before
grouped-query attention and before a SwiGLU MLP (``silu(y wg) * (y wi)``,
then ``wo``), each added to the residual; a final RMSNorm; an untied head
``lm_head/w`` ``[hidden, vocab]``; no biases anywhere.

- RoPE on q and k at positions 0..S-1, frequencies ``theta ** (-2i / d)``
  for i < d / 2, in the NeoX convention that ``ops/layers.py``'s
  ``apply_rope`` uses: the head's two halves (not interleaved pairs) are
  rotated, ``[x1 cos - x2 sin, x2 cos + x1 sin]``.
- Grouped-query attention: kv head j serves the query heads j g ..
  (j + 1) g - 1, g = heads / kv heads (``repeat_kv``'s grouping), softmax
  of q k^T / sqrt(d) under the causal mask.
"""

from __future__ import annotations

import math

import torch

from port_bench.reference import core


class Model:
    """The forward and loss of one block of rows (``core.py``'s model)."""

    def __init__(self, cfg: dict):
        self.h, self.L = cfg["hidden_size"], cfg["num_hidden_layers"]
        self.n, self.kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
        self.d = self.h // self.n
        self.eps = float(cfg["rms_norm_eps"])
        self.theta = float(cfg["rope_theta"])

    def rms(self, x, scale):
        return x / torch.sqrt(x.square().mean(dim=-1, keepdim=True) + self.eps) * scale

    def rope(self, x):
        """x [rows, heads, S, d], rotated by position."""
        s, d = x.shape[-2], x.shape[-1]
        inv = 1.0 / self.theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                                device=x.device) / d)
        angle = torch.outer(torch.arange(s, dtype=torch.float32, device=x.device), inv)
        cos, sin = torch.cos(angle), torch.sin(angle)
        x1, x2 = x[..., : d // 2], x[..., d // 2:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def attend(self, q, k, v, mm):
        """q [rows, heads, S, d], k and v [rows, kv heads, S, d] -> [rows,
        S, heads * d]."""
        rows, n, s, d = q.shape
        group = n // self.kv
        k, v = k.repeat_interleave(group, dim=1), v.repeat_interleave(group, dim=1)
        scores = mm(q, k.transpose(-1, -2)) / math.sqrt(d)
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        probs = torch.softmax(scores.masked_fill(~keep, float("-inf")), dim=-1)
        return mm(probs, v).transpose(1, 2).reshape(rows, s, n * d)

    def block(self, p: dict, inputs, labels, weight, mm, stats):
        """(sum of ``weight`` x the token cross entropy over a block, no
        microbatch term)."""
        rows, s = inputs.shape
        h, d = self.h, self.d
        x = p["embed/tokens"][inputs]
        for i in range(self.L):
            y = self.rms(x, p["layers/attn_norm/scale"][i])

            def heads(w, n):
                return mm(y, w[i].reshape(h, n * d)).view(rows, s, n, d).transpose(1, 2)

            q = self.rope(heads(p["layers/attn/wq"], self.n))
            k = self.rope(heads(p["layers/attn/wk"], self.kv))
            o = self.attend(q, k, heads(p["layers/attn/wv"], self.kv), mm)
            x = x + mm(o, p["layers/attn/wo"][i].reshape(self.n * d, h))
            y = self.rms(x, p["layers/mlp_norm/scale"][i])
            gate = mm(y, p["layers/mlp/wg"][i])
            x = x + mm(gate * torch.sigmoid(gate) * mm(y, p["layers/mlp/wi"][i]),
                       p["layers/mlp/wo"][i])
        x = self.rms(x, p["final_norm/scale"]).reshape(rows * s, h)
        gold = labels.reshape(-1)
        logits = mm(x, p["lm_head/w"])
        nll = torch.logsumexp(logits, dim=-1) - logits.gather(1, gold[:, None])[:, 0]
        if weight is None:
            return nll.sum(), None
        return (nll * weight.reshape(-1)).sum(), None


def train(cfg: dict, runtime: dict, weights: dict, batches: list, **kwargs) -> dict:
    return core.train(cfg, runtime, weights, batches, model=Model(cfg), weight_key=None,
                      **kwargs)
