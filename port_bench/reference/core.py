"""The plain reference's training steps, for every family: PyTorch in
float32 with TF32 off, no kernels, no cache, nothing of the program.

A family's file (``<family>.py``) hands :func:`train` its model, an object
with

- ``block(p, inputs, labels, weight, mm, stats)`` -> ``(nll, term)``: over
  a block of a microbatch's rows, ``nll`` the sum of ``weight`` x the token
  cross entropy (``weight`` None: every position counts once), and
  ``term`` this block's share of a term of the microbatch's loss that is
  not a mean over its tokens (None where the model has none). ``p`` maps
  the weights' ``/``-joined paths to tensors; every matrix product goes
  through ``mm``;
- optionally ``stats(p, inputs, weight, mm)``: a pass over the whole
  microbatch without gradients, whose result the loop hands to each
  block as ``stats``. A term such as an MoE balance, E x sum_e f_e P_e
  with f_e the share of the microbatch's assignments on expert e (no
  gradient) and P_e its mean router probability, is then a sum over
  blocks: f from ``stats``, each block's share of P's sum over T.

A step is the trainer's: the batch in ``microbatches`` row slices, each
slice's loss its own mean (``nll`` over the slice's counted positions,
plus ``term``) and the step's gradient the mean over slices; the global
norm clip; AdamW (optax's order: Adam's moments, the decoupled weight decay
on every leaf, then minus the scheduled rate, which reads the update count
before it is incremented, so with warmup the first update is zero).

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


def fp8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The control's matrix product: both operands through float8."""
    return torch.matmul(_Fp8.apply(a), _Fp8.apply(b))


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


def train(cfg: dict, runtime: dict, weights: dict, batches: list, *, model,
          weight_key, microbatches: int, block_tokens: int, device, quant: bool = False,
          keep_rows: float = 1.0) -> dict:
    """Train ``model`` from ``weights`` (which stay as they are) on
    ``batches``, one step each; ``weight_key`` names the batch's loss
    weights (None: every position). Returns each step's loss, the first
    moment after the first step and each weight's change over all the steps
    (``{path: tensor}``)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _train(cfg, runtime, weights, batches, model, weight_key, microbatches,
                      block_tokens, device, fp8_matmul if quant else torch.matmul, keep_rows)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _train(cfg, runtime, weights, batches, model, weight_key, k, block_tokens, device, mm,
           keep_rows):
    opt = cfg["optimizer"]
    stats_of = getattr(model, "stats", None)
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
            stats = None
            if stats_of is not None:
                with torch.no_grad():
                    stats = stats_of(params, take["inputs"], weight, mm)
            block = max(block_tokens // take["inputs"].shape[1], 1)
            for a in range(0, hi - lo, block):
                w_blk = None if weight is None else weight[a:a + block]
                nll, term = model.block(params, take["inputs"][a:a + block],
                                        take["labels"][a:a + block], w_blk, mm, stats)
                part = nll / max(count_tokens, 1.0) / k
                if term is not None:
                    part = part + term / k
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
