"""The plain reference of a learned-position transformer's training steps:
PyTorch in float32 with TF32 off, no kernels, no cache, nothing of the
program.

It follows the port's stated architecture, which ``bert.py`` and
``gpt2.py`` name: token and learned position embeddings; per layer a
pre-LayerNorm attention block (q, k, v and o projections with biases,
softmax attention, causal or not) and a pre-LayerNorm MLP (GELU, tanh
approximation), each added to the residual; a final LayerNorm; the head tied
to the token table; the mean cross entropy over the positions the loss
reads. A step is the trainer's: the batch in ``microbatches`` row slices,
each slice's loss its own mean and the step's gradient the mean over
slices; the global norm clip; AdamW (optax's order: Adam's moments, the
decoupled weight decay on every leaf, then minus the scheduled rate, which
reads the update count before it is incremented, so with warmup the first
update is zero).

Each slice runs in blocks of rows so that the f32 activations fit beside
the model, the gradients summed over the blocks. ``quant=True`` is the
control: every matrix product's operands rounded to float8 (e4m3 forward,
e5m2 for the gradients flowing back, one scale a tensor), as an FP8
training step would compute them. ``keep_rows`` < 1 is a planted fault: each
slice keeps that share of its rows and takes its mean over them.
"""

from __future__ import annotations

import math

import torch

_FP8 = {"e4m3": (torch.float8_e4m3fn, 448.0), "e5m2": (torch.float8_e5m2, 57344.0)}


def _round8(x: torch.Tensor, fmt: str) -> torch.Tensor:
    dtype, top = _FP8[fmt]
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return ((x / scale).to(dtype).to(x.dtype) * scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round8(x, "e4m3")

    @staticmethod
    def backward(ctx, g):
        return _round8(g, "e5m2")


class Model:
    """The forward and loss of one block of rows; ``p`` maps the weights'
    ``/``-joined paths to tensors."""

    def __init__(self, cfg: dict, causal: bool, quant: bool = False):
        self.h, self.L = cfg["hidden_size"], cfg["num_hidden_layers"]
        self.n = cfg["num_attention_heads"]
        self.d = self.h // self.n
        self.eps = float(cfg["layer_norm_eps"])
        self.causal = causal
        self.quant = quant

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.quant:
            a, b = _Fp8.apply(a), _Fp8.apply(b)
        return torch.matmul(a, b)

    def ln(self, x, scale, bias):
        mean = x.mean(dim=-1, keepdim=True)
        var = (x - mean).square().mean(dim=-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + self.eps) * scale + bias

    @staticmethod
    def gelu(x):
        return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))

    def attend(self, q, k, v):
        """q, k, v [rows, heads, S, d] -> [rows, S, heads * d]."""
        rows, n, s, d = q.shape
        scores = self.mm(q, k.transpose(-1, -2)) / math.sqrt(d)
        if self.causal:
            keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
            scores = scores.masked_fill(~keep, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        return self.mm(probs, v).transpose(1, 2).reshape(rows, s, n * d)

    def nll_sum(self, p: dict, inputs, labels, weight) -> torch.Tensor:
        """Sum of ``weight`` x the token cross entropy over a block."""
        rows, s = inputs.shape
        h, n, d = self.h, self.n, self.d
        x = p["embed/tokens"][inputs] + p["embed/pos"][:s]
        for i in range(self.L):
            y = self.ln(x, p["layers/attn_norm/scale"][i], p["layers/attn_norm/bias"][i])

            def heads(w, b):
                out = self.mm(y, w[i].reshape(h, n * d)) + b[i].reshape(n * d)
                return out.view(rows, s, n, d).transpose(1, 2)

            o = self.attend(heads(p["layers/attn/wq"], p["layers/attn/bq"]),
                            heads(p["layers/attn/wk"], p["layers/attn/bk"]),
                            heads(p["layers/attn/wv"], p["layers/attn/bv"]))
            x = x + self.mm(o, p["layers/attn/wo"][i].reshape(n * d, h)) + p["layers/attn/bo"][i]
            y = self.ln(x, p["layers/mlp_norm/scale"][i], p["layers/mlp_norm/bias"][i])
            mid = self.gelu(self.mm(y, p["layers/mlp/wi"][i]) + p["layers/mlp/bi"][i])
            x = x + self.mm(mid, p["layers/mlp/wo"][i]) + p["layers/mlp/bo"][i]
        x = self.ln(x, p["final_norm/scale"], p["final_norm/bias"])
        if weight is None:
            hid, gold, w = x.reshape(rows * s, h), labels.reshape(-1), None
        else:
            # only the positions the loss reads need the head
            at = weight.reshape(-1) > 0
            hid, gold, w = x.reshape(rows * s, h)[at], labels.reshape(-1)[at], \
                weight.reshape(-1)[at]
        logits = self.mm(hid, p["embed/tokens"].t())
        nll = torch.logsumexp(logits, dim=-1) - logits.gather(1, gold[:, None])[:, 0]
        return nll.sum() if w is None else (nll * w).sum()


def learning_rate(opt: dict, runtime: dict, count: int) -> float:
    """The scheduled rate at update ``count``: linear warmup from 0, then
    cosine decay to ``min_lr_ratio`` of the peak."""
    peak = float(runtime["learning_rate"])
    steps = int(runtime["steps"])
    warmup = int(runtime.get("warmup_steps", min(100, steps // 10 + 1)))
    if count < warmup:
        return peak * count / warmup
    decay = max(steps - warmup, 1)
    c = min(count - warmup, decay)
    alpha = float(opt["min_lr_ratio"])
    return peak * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay)) + alpha)


def train(cfg: dict, runtime: dict, weights: dict, batches: list, *, causal: bool,
          weight_key, microbatches: int, block_tokens: int, device, quant: bool = False,
          keep_rows: float = 1.0) -> dict:
    """Train from ``weights`` (which stay as they are) on ``batches``, one
    step each. Returns each step's loss, the first moment after the first
    step and each weight's change over all the steps (``{path:
    tensor}``)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _train(cfg, runtime, weights, batches, causal, weight_key, microbatches,
                      block_tokens, device, quant, keep_rows)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _train(cfg, runtime, weights, batches, causal, weight_key, k, block_tokens, device,
           quant, keep_rows):
    opt = cfg["optimizer"]
    model = Model(cfg, causal, quant)
    params = {name: w.detach().clone().requires_grad_() for name, w in weights.items()}
    mu = {name: torch.zeros_like(w) for name, w in params.items()}
    nu = {name: torch.zeros_like(w) for name, w in params.items()}
    b1, b2, eps = float(opt["b1"]), float(opt["b2"]), float(opt["eps"])
    losses, first_mu = [], None
    for count, batch in enumerate(batches):
        rows = batch["inputs"].shape[0]
        per = rows // k
        step_loss = 0.0
        for j in range(k):
            lo, hi = j * per, j * per + max(int(per * keep_rows), 1)
            take = {key: t[lo:hi].to(device) for key, t in batch.items()}
            weight = take[weight_key].float() if weight_key else None
            count_tokens = float(weight.sum()) if weight is not None else \
                float(take["labels"].numel())
            block = max(block_tokens // take["inputs"].shape[1], 1)
            for a in range(0, hi - lo, block):
                w_blk = None if weight is None else weight[a:a + block]
                part = model.nll_sum(params, take["inputs"][a:a + block],
                                     take["labels"][a:a + block], w_blk)
                part = part / max(count_tokens, 1.0) / k
                part.backward()
                step_loss += float(part.detach())
        losses.append(step_loss)
        with torch.no_grad():
            grads = {name: p.grad for name, p in params.items()}
            norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
            clip = float(opt["grad_clip"])
            factor = 1.0 if float(norm) < clip else clip / float(norm)
            t = count + 1
            c1, c2 = 1 - b1 ** t, 1 - b2 ** t
            lr = learning_rate(opt, runtime, count)
            for name, p in params.items():
                g = grads[name] * factor
                mu[name].mul_(b1).add_(g, alpha=1 - b1)
                nu[name].mul_(b2).add_(g * g, alpha=1 - b2)
                u = (mu[name] / c1) / (torch.sqrt(nu[name] / c2) + eps)
                p.add_(u + float(opt["weight_decay"]) * p, alpha=-lr)
                p.grad = None
            if count == 0:
                first_mu = {name: m.clone() for name, m in mu.items()}
    with torch.no_grad():
        change = {name: p.detach() - weights[name] for name, p in params.items()}
    return {"loss": losses, "mu": first_mu, "change": change}
