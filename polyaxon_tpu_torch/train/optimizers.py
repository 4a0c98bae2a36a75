"""AdamW and its learning-rate schedules for the port — counterpart of
``polyaxon_tpu/train/optimizers.py`` (optax there).

Plain functions over lists of tensors, not ``torch.optim``: the update is
the JAX package's optax chain step for step — clip by the global norm, Adam
with moments stored in their own dtypes (bf16 moments for f32 params, which
``torch.optim.AdamW`` cannot hold), decoupled weight decay on every leaf,
then the scheduled -lr. The schedule reads the update count before it is
incremented, as optax's does, so with warmup the first update is zero.
Only AdamW is ported; the other optimizers of the JAX package wait for
ROADMAP A4.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"               # adamw (the only one ported)
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"          # cosine | linear | constant
    min_lr_ratio: float = 0.1
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    # reduced-precision moments: storage only, the moment math runs in f32
    mu_dtype: Optional[str] = None    # e.g. "bfloat16"; None = param dtype
    nu_dtype: Optional[str] = None    # e.g. "bfloat16"; None = param dtype


def _f32(x: float) -> float:
    """Round to float32, as optax evaluates its schedules."""
    return float(torch.tensor(x, dtype=torch.float32))


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    def f(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return _f32((init - end) * frac + end)
    return f


def _cosine(init: float, steps: int, alpha: float) -> Callable[[int], float]:
    def f(count: int) -> float:
        c = min(max(count, 0), steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / steps))
        return _f32(init * ((1.0 - alpha) * cosine + alpha))
    return f


def make_schedule(cfg: OptimizerConfig) -> Callable[[int], float]:
    """count -> learning rate: linear warmup from 0, then cosine, linear or
    constant decay (optax's ``join_schedules`` of the two)."""
    peak = cfg.learning_rate
    end = peak * cfg.min_lr_ratio
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
    if cfg.schedule == "cosine":
        decay = _cosine(peak, decay_steps, cfg.min_lr_ratio)
    elif cfg.schedule == "linear":
        decay = _linear(peak, end, decay_steps)
    elif cfg.schedule == "constant":
        decay = lambda count: _f32(peak)  # noqa: E731
    else:
        raise ValueError(f"Unknown schedule {cfg.schedule!r}")
    if cfg.warmup_steps <= 0:
        return decay
    warmup = _linear(0.0, peak, cfg.warmup_steps)
    return lambda count: warmup(count) if count < cfg.warmup_steps \
        else decay(count - cfg.warmup_steps)


def _scaled(c: float, t: torch.Tensor) -> torch.Tensor:
    """c * t with c rounded to t's dtype first, as JAX multiplies a
    tensor by a Python scalar."""
    return torch.tensor(c, dtype=t.dtype, device=t.device) * t


def _dtype(name: Optional[str]) -> Optional[torch.dtype]:
    return getattr(torch, name) if name else None


@dataclass
class AdamState:
    """Adam's count and moments, one moment tensor per param. ``count`` is
    the number of applied updates (a skipped step does not advance it)."""
    count: int
    mu: list
    nu: list


def global_norm(tensors: list) -> torch.Tensor:
    """optax's ``global_norm``: each leaf's squares in its dtype, summed
    (in f32, rounded to the leaf's dtype), then summed across leaves in
    order, then the square root."""
    total = None
    for t in tensors:
        sq = (t * t).float().sum().to(t.dtype)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads: list, max_norm: float) -> list:
    """optax's ``clip_by_global_norm``: unchanged below ``max_norm``,
    else each leaf times max_norm / norm, in the leaf's dtype."""
    g_norm = global_norm(grads)
    trigger = g_norm < max_norm
    return [torch.where(trigger, g, (g / g_norm.to(g.dtype)) * max_norm) for g in grads]


def scale_by_adam(g, m, v, *, c1: float, c2: float, b1: float, b2: float,
                  eps: float = 1e-8):
    """One leaf of ``optax.scale_by_adam`` (optax.adamw's): each product in
    its operand's dtype, the decay constant rounded to that dtype first
    (JAX's weak scalars), the sums promoted; the update comes from that
    first moment, which is stored cast down after. ``c1``/``c2`` are the
    bias corrections of this count. Returns (update, mu, nu)."""
    m_new = _scaled(1 - b1, g) + _scaled(b1, m)
    v_new = _scaled(1 - b2, g * g) + _scaled(b2, v)
    u = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
    return u, m_new.to(m.dtype), v_new


def scale_by_adam_lowmem(g, m, v, *, c1: float, c2: float, b1: float, b2: float,
                         eps: float = 1e-8):
    """One leaf of the JAX package's ``scale_by_adam_lowmem``: both moments
    stored in their own (reduced) dtypes, the moment math and the update
    in f32 from the stored moments. Returns (update, mu, nu)."""
    g32 = g.float()
    m_new = (b1 * m.float() + (1 - b1) * g32).to(m.dtype)
    v_new = (b2 * v.float() + (1 - b2) * g32 * g32).to(v.dtype)
    u = (m_new.float() / c1) / (torch.sqrt(v_new.float() / c2) + eps)
    return u, m_new, v_new


class AdamW:
    """``make_optimizer(cfg)`` for ``name: adamw``: clip -> Adam -> decay
    -> -lr. ``init(params)`` gives the state; ``update(grads, state,
    params)`` returns (updates, new state), the updates in f32 for the
    caller to add to the f32 master params."""

    def __init__(self, cfg: OptimizerConfig):
        if cfg.name != "adamw":
            raise ValueError(f"optimizer {cfg.name!r} is not ported; only adamw "
                             f"(ROADMAP A4)")
        self.cfg = cfg
        self.schedule = make_schedule(cfg)
        self.mu_dtype = _dtype(cfg.mu_dtype)
        # with nu_dtype set the JAX package runs scale_by_adam_lowmem;
        # without it, optax.adamw (whose nu stays in the param dtype)
        self.nu_dtype = _dtype(cfg.nu_dtype)
        self.adam = scale_by_adam_lowmem if cfg.nu_dtype else scale_by_adam

    def init(self, params: list) -> AdamState:
        return AdamState(
            count=0,
            mu=[torch.zeros_like(p, dtype=self.mu_dtype or p.dtype) for p in params],
            nu=[torch.zeros_like(p, dtype=self.nu_dtype or p.dtype) for p in params])

    def update(self, grads: list, state: AdamState, params: list):
        cfg = self.cfg
        if cfg.grad_clip and cfg.grad_clip > 0:
            grads = clip_by_global_norm(grads, cfg.grad_clip)
        count = state.count + 1
        consts = dict(c1=_f32(1 - cfg.b1 ** count), c2=_f32(1 - cfg.b2 ** count),
                      b1=cfg.b1, b2=cfg.b2)
        lr = self.schedule(state.count)
        mus, nus, updates = [], [], []
        for g, m, v, p in zip(grads, state.mu, state.nu, params):
            u, m_new, v_new = self.adam(g, m, v, **consts)
            mus.append(m_new)
            nus.append(v_new)
            u = u + cfg.weight_decay * p
            updates.append(torch.tensor(-lr, dtype=u.dtype, device=u.device) * u)
        return updates, AdamState(count=count, mu=mus, nu=nus)


def make_optimizer(cfg: OptimizerConfig) -> AdamW:
    return AdamW(cfg)
