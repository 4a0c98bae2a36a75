"""Optimizers and their learning-rate schedules for the port — counterpart
of ``polyaxon_tpu/train/optimizers.py`` (optax there).

Plain functions over lists of tensors, not ``torch.optim``: each update is
the JAX package's optax chain step for step, with the clip by the global
norm first. ``adamw`` is optax.adamw with moments stored in their own
dtypes (bf16 moments for f32 params, which ``torch.optim.AdamW`` cannot
hold), decoupled weight decay on every leaf, then the scheduled -lr;
``sgd`` is optax.sgd with momentum (a trace, nesterov off, no decay);
``lion`` is optax.lion; ``adafactor`` is optax.adafactor at its defaults
(factored second moments over each leaf's two largest dims, the update
clipped to RMS 1 and scaled by the param's RMS). Every schedule reads the
update count before it is incremented, as optax's does, so with warmup the
first update is zero.

Over a mesh each leaf is this rank's block of a logical leaf cut over some
axes (the trainer's ``(axis, dim)`` cuts). adamw, sgd and lion are
elementwise and run on the blocks as they are. adafactor is not: it reads
the whole leaf, as optax does under GSPMD. :meth:`Adafactor.layout` gives it
each leaf's logical shape, its cuts and the mesh; it factors by the logical
shape, keeps the factors whole on every rank (the JAX trainer replicates
them), and sums the block's partial means and squares over the axes that
cut the leaf (see :class:`Adafactor`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import Callable, Optional

import numpy as np
import torch


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"               # adamw | sgd | lion | adafactor
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"          # cosine | linear | constant
    min_lr_ratio: float = 0.1
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    momentum: float = 0.9             # sgd
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


@dataclass
class SgdState:
    """The momentum trace (param dtype) and the schedule's count."""
    count: int
    trace: list


@dataclass
class LionState:
    """Lion's momentum (``mu_dtype``) and the schedule's count."""
    count: int
    mu: list


@dataclass
class AdafactorState:
    """optax's ``FactoredState``: per param, the row and column second
    moments of a factored leaf, or the full second moment of one that is
    not, with a ``(1,)`` placeholder in the other slots."""
    count: int
    v_row: list
    v_col: list
    v: list


#: every optimizer state; a checkpoint's ``opt_state`` names its fields
OPT_STATES = (AdamState, SgdState, LionState, AdafactorState)


def opt_state_tree(state) -> dict:
    """An optimizer state as a checkpoint's tree: its fields by name (the
    tensors are the state's own)."""
    return {f.name: getattr(state, f.name) for f in fields(state)}


def opt_state_from_tree(tree: dict):
    """The optimizer state whose fields the tree's keys name."""
    for cls in OPT_STATES:
        if {f.name for f in fields(cls)} == set(tree):
            return cls(count=int(tree["count"]),
                       **{k: list(v) for k, v in tree.items() if k != "count"})
    raise ValueError(f"no optimizer state has the fields {sorted(tree)}")


def global_norm(tensors: list, whole: Optional[Callable[[list], list]] = None) -> torch.Tensor:
    """optax's ``global_norm``: each leaf's squares in its dtype, summed
    (in f32, rounded to the leaf's dtype), then summed across leaves in
    order, then the square root. ``whole`` turns the list of each leaf's
    f32 sums into the whole leaves' (fsdp shards: summed over the ranks).
    No leaves: 0 (an optimizer that trains none of them)."""
    if not tensors:
        return torch.zeros(())
    sums = [(t * t).float().sum() for t in tensors]
    if whole is not None:
        sums = whole(sums)
    total = None
    for t, s in zip(tensors, sums):
        sq = s.to(t.dtype)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads: list, max_norm: float,
                        g_norm: Optional[torch.Tensor] = None) -> list:
    """optax's ``clip_by_global_norm``: unchanged below ``max_norm``,
    else each leaf times max_norm / norm, in the leaf's dtype. ``g_norm``:
    the grads' global norm when the caller has it (a sharded step's)."""
    if g_norm is None:
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


class _Optimizer:
    """``init(params)`` gives the state; ``update(grads, state, params)``
    clips the grads by their global norm and returns (updates, new state),
    the updates for the caller to add to the f32 master params."""

    def __init__(self, cfg: OptimizerConfig):
        self.cfg = cfg
        self.schedule = make_schedule(cfg)

    def init(self, params: list):
        raise NotImplementedError

    def layout(self, shapes: list, cuts: list, mesh) -> None:
        """Each leaf's logical shape and ``(axis, dim)`` cuts over ``mesh``:
        an elementwise update runs on the blocks as they are."""

    def update(self, grads: list, state, params: list,
               g_norm: Optional[torch.Tensor] = None):
        if self.cfg.grad_clip and self.cfg.grad_clip > 0:
            grads = clip_by_global_norm(grads, self.cfg.grad_clip, g_norm)
        return self._update(grads, state, params, self.schedule(state.count))

    def _update(self, grads: list, state, params: list, lr: float):
        raise NotImplementedError


def _times_lr(lr: float, u: torch.Tensor) -> torch.Tensor:
    """optax's ``scale_by_learning_rate``: -lr in the update's dtype, times
    the update."""
    return torch.tensor(-lr, dtype=u.dtype, device=u.device) * u


class AdamW(_Optimizer):
    """clip -> Adam -> decay -> -lr."""

    def __init__(self, cfg: OptimizerConfig):
        super().__init__(cfg)
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

    def _update(self, grads, state: AdamState, params, lr):
        cfg = self.cfg
        count = state.count + 1
        consts = dict(c1=_f32(1 - cfg.b1 ** count), c2=_f32(1 - cfg.b2 ** count),
                      b1=cfg.b1, b2=cfg.b2)
        mus, nus, updates = [], [], []
        for g, m, v, p in zip(grads, state.mu, state.nu, params):
            u, m_new, v_new = self.adam(g, m, v, **consts)
            mus.append(m_new)
            nus.append(v_new)
            updates.append(_times_lr(lr, u + cfg.weight_decay * p))
        return updates, AdamState(count=count, mu=mus, nu=nus)


class Sgd(_Optimizer):
    """clip -> ``optax.trace(momentum)`` (t = g + momentum * t) -> -lr."""

    def init(self, params: list) -> SgdState:
        return SgdState(count=0, trace=[torch.zeros_like(p) for p in params])

    def _update(self, grads, state: SgdState, params, lr):
        traces = [g + _scaled(self.cfg.momentum, t) for g, t in zip(grads, state.trace)]
        updates = [_times_lr(lr, t) for t in traces]
        return updates, SgdState(count=state.count + 1, trace=traces)


class Lion(_Optimizer):
    """clip -> ``optax.scale_by_lion`` (sign of b1's interpolation; the
    momentum an EMA at b2, stored in ``mu_dtype``) -> decay -> -lr."""

    def init(self, params: list) -> LionState:
        dt = _dtype(self.cfg.mu_dtype)
        return LionState(count=0, mu=[torch.zeros_like(p, dtype=dt or p.dtype)
                                      for p in params])

    def _update(self, grads, state: LionState, params, lr):
        cfg = self.cfg
        mus, updates = [], []
        for g, m, p in zip(grads, state.mu, params):
            u = torch.sign(_scaled(1.0 - cfg.b1, g) + _scaled(cfg.b1, m))
            mus.append((_scaled(1 - cfg.b2, g) + _scaled(cfg.b2, m)).to(m.dtype))
            updates.append(_times_lr(lr, u + cfg.weight_decay * p))
        return updates, LionState(count=state.count + 1, mu=mus)


#: optax.adafactor's defaults (optax 0.2.6)
ADAFACTOR_MIN_DIM_TO_FACTOR = 128
ADAFACTOR_DECAY_RATE = 0.8
ADAFACTOR_EPS = 1e-30
ADAFACTOR_CLIP_RMS = 1.0
ADAFACTOR_MIN_PARAM_RMS = 1e-3


def factored_dims(shape) -> Optional[tuple[int, int]]:
    """optax's ``_factored_dims``: (d1, d0), the second largest and the
    largest dim, by numpy's argsort of the shape (its order among equal
    sizes too), or None when the leaf has one dim or its second largest
    is under 128. A layer-stacked ``[L, h, m]`` leaf factors over h and m."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < ADAFACTOR_MIN_DIM_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


def _rms(t: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(t * t))


class Adafactor(_Optimizer):
    """clip -> ``optax.scale_by_factored_rms`` -> ``clip_by_block_rms(1)``
    -> lr -> times the param's RMS (at least 1e-3) -> negate.

    Over a mesh (:meth:`layout`) a leaf is factored by its logical shape,
    ``v_row`` and ``v_col`` are the whole factors on every rank, and the
    unfactored ``v`` is the param's block. A factor's mean over a dim is
    the block's mean, then, for each cut of the leaf: over a dim the
    factor reduces, the ranks' means summed over that axis and divided by
    its size (a mean of equal blocks' means); over a dim it keeps, the
    ranks' slices gathered. The update's and the param's RMS take the
    block's mean square the same way. On one rank each step is the
    single-process expression, bit for bit. A leaf replicated over an axis
    holds the same values on every rank there, and takes no sum over it."""

    def __init__(self, cfg: OptimizerConfig):
        super().__init__(cfg)
        self._shapes: Optional[list] = None
        self._cuts: Optional[list] = None
        self._mesh = None

    def layout(self, shapes: list, cuts: list, mesh) -> None:
        if any(cuts):
            self._shapes, self._cuts, self._mesh = [tuple(s) for s in shapes], list(cuts), mesh
        else:
            self._shapes = self._cuts = self._mesh = None

    def _leaf(self, i: int, p: torch.Tensor) -> tuple:
        """(logical shape, cuts) of leaf ``i``."""
        if self._cuts is None:
            return tuple(p.shape), ()
        return self._shapes[i], self._cuts[i]

    def _mean(self, t: torch.Tensor, dim: int, cuts: tuple) -> torch.Tensor:
        """The whole leaf's mean over ``dim`` of the block ``t``, whole
        over the other dims."""
        out = t.mean(dim=dim)
        for axis, d in cuts:
            if d == dim:
                out = self._mesh.sum_(out.contiguous(), axis) / self._mesh.sizes[axis]
            else:
                out = self._mesh.gather_full(out, [(axis, d if d < dim else d - 1)])
        return out

    def _block(self, t: torch.Tensor, dim: int, cuts: tuple) -> torch.Tensor:
        """This rank's block of a whole factor that reduced ``dim``."""
        for axis, d in cuts:
            if d != dim:
                t = self._mesh.block(t, d if d < dim else d - 1, axis)
        return t

    def _rms(self, t: torch.Tensor, cuts: tuple) -> torch.Tensor:
        """The whole leaf's RMS of the block ``t``."""
        if not cuts:
            return _rms(t)
        ms = torch.mean(t * t).reshape(1)
        for axis in dict.fromkeys(a for a, _ in cuts):
            ms = self._mesh.sum_(ms, axis) / self._mesh.sizes[axis]
        return torch.sqrt(ms[0])

    def init(self, params: list) -> AdafactorState:
        state = AdafactorState(count=0, v_row=[], v_col=[], v=[])
        for i, p in enumerate(params):
            shape, _ = self._leaf(i, p)
            dims = factored_dims(shape)
            one = torch.zeros(1, dtype=p.dtype, device=p.device)
            if dims is None:
                state.v_row.append(one)
                state.v_col.append(one.clone())
                state.v.append(torch.zeros_like(p))
            else:
                d1, d0 = dims
                zeros = lambda drop: torch.zeros(  # noqa: E731
                    shape[:drop] + shape[drop + 1:], dtype=p.dtype, device=p.device)
                state.v_row.append(zeros(d0))
                state.v_col.append(zeros(d1))
                state.v.append(one)
        return state

    def _update(self, grads, state: AdafactorState, params, lr):
        # the decay of the second moments, 1 - (count + 1)^-0.8, and its
        # complement, each an f32 value (optax computes both in f32)
        t = torch.tensor(state.count + 1, dtype=torch.float32)
        decay = float(1.0 - t ** -ADAFACTOR_DECAY_RATE)
        keep = _f32(1.0 - decay)
        new = AdafactorState(count=state.count + 1, v_row=[], v_col=[], v=[])
        updates = []
        for i, (g, vr, vc, v, p) in enumerate(zip(grads, state.v_row, state.v_col, state.v,
                                                  params)):
            shape, cuts = self._leaf(i, p)
            sq = g * g + ADAFACTOR_EPS
            dims = factored_dims(shape)
            if dims is None:
                v = (decay * v + keep * sq).to(p.dtype)
                u = g * v ** -0.5
            else:
                d1, d0 = dims
                vr = (decay * vr + keep * self._mean(sq, d0, cuts)).to(p.dtype)
                vc = (decay * vc + keep * self._mean(sq, d1, cuts)).to(p.dtype)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row = (vr / vr.mean(dim=reduced_d1, keepdim=True)) ** -0.5
                u = g * self._block(row, d0, cuts).unsqueeze(d0) \
                    * self._block(vc ** -0.5, d1, cuts).unsqueeze(d1)
            new.v_row.append(vr)
            new.v_col.append(vc)
            new.v.append(v)
            u = u / torch.clamp(self._rms(u, cuts) / ADAFACTOR_CLIP_RMS, min=1.0)
            u = torch.tensor(lr, dtype=u.dtype, device=u.device) * u
            p_rms = self._rms(p, cuts)
            u = u * torch.where(p_rms <= ADAFACTOR_MIN_PARAM_RMS,
                                torch.full_like(p_rms, ADAFACTOR_MIN_PARAM_RMS), p_rms)
            updates.append(-u)
        return updates, new


def state_cuts(state, cuts: list) -> dict:
    """Field name -> the cuts of each of its tensors (``cuts``: the
    params'): a param-shaped moment is cut as its param; adafactor's
    factors, and the one-element placeholders beside them, are whole on
    every rank (the JAX trainer replicates every state leaf whose shape is
    not its param's)."""
    out = {}
    for f in fields(state):
        if f.name == "count":
            continue
        if isinstance(state, AdafactorState) and f.name != "v":
            out[f.name] = [()] * len(cuts)
        elif isinstance(state, AdafactorState):
            # a factored leaf's v is the placeholder; its v_row is not
            out[f.name] = [() if r.numel() > 1 else c for r, c in zip(state.v_row, cuts)]
        else:
            out[f.name] = list(cuts)
    return out


OPTIMIZERS = {"adamw": AdamW, "sgd": Sgd, "lion": Lion, "adafactor": Adafactor}


def make_optimizer(cfg: OptimizerConfig) -> _Optimizer:
    if cfg.name not in OPTIMIZERS:
        raise ValueError(f"Unknown optimizer {cfg.name!r}; valid: {'|'.join(OPTIMIZERS)}")
    return OPTIMIZERS[cfg.name](cfg)
