"""Ring attention: exact attention over a sequence cut into chunks along a
ring of ranks (the ``context`` axis) — port of
``polyaxon_tpu/ops/ring_attention.py``.

Each rank holds its chunk ``[my·s, (my+1)·s)`` of q, k and v. The k/v
chunks travel the ring, one step a visit; at each visit the rank runs the
flash forward (B1, ``_flash_fwd``) of its q against the visiting chunk at
the chunks' global offsets and merges the partial result with the
log-sum-exp rule. The next chunk's exchange is posted before the visit's
kernels, so it travels while they run. A chunk entirely in the causal
future is skipped; the exchange runs on every step all the same, or the
ranks would deadlock.

The backward is a second ring (one ``torch.autograd.Function``, the JAX
custom VJP): flash's backward needs only the global row LSE and δ =
rowsum(dO∘O), so each visit runs the dQ and dK/dV kernels (B2, B3) at the
same offsets, with δ computed once (``bwd_row_stats``). dK/dV ride the
ring with their chunk and reach home after the full ``cp`` shifts.

GQA: the compact kv heads ride the ring and are expanded per visit.

The ring is a parameter (``exchange``): :class:`~..parallel.collectives.RingExchange`
over the context group, one position per process, or :class:`LoopbackRing`,
which holds every position in one process (it cuts the whole sequence
into its chunks and rotates them in memory), so the ring's arithmetic runs
on one device. The offsets are Python ints, one pair per visit.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import _flash_bwd, _flash_fwd, bwd_row_stats

_NEG_INF = float("-inf")


def _merge(o, lse, o_i, lse_i):
    """Merge normalized partial attention (o_i, lse_i) into the running
    (o, lse), in f32; -inf on either side (a row that saw no key) weighs
    nothing."""
    lse_new = torch.logaddexp(lse, lse_i)
    safe = torch.where(lse_new == _NEG_INF, torch.zeros_like(lse_new), lse_new)
    w_prev = torch.where(lse == _NEG_INF, torch.zeros_like(lse), torch.exp(lse - safe))
    w_i = torch.where(lse_i == _NEG_INF, torch.zeros_like(lse_i), torch.exp(lse_i - safe))
    return o * w_prev[..., None] + o_i.float() * w_i[..., None], lse_new


def _visit_pred(causal: bool, src: int, my: int) -> bool:
    """Does rank ``my`` visit chunk ``src``? Causal skips chunks entirely in
    the causal future; the forward and backward sweeps share it. (The JAX
    package's pipeline gate, its ``gated`` half, has no counterpart here:
    the port's pipeline skips an idle tick's ring whole.)"""
    return not causal or src <= my


def _expand_kv(kc: torch.Tensor, group: int) -> torch.Tensor:
    """[b*nk, s, d] -> [b*nk*group, s, d], each kv head repeated ``group``
    times contiguously (``repeat_kv``'s convention: q head i reads kv head
    i // group). Runs per visit, so the ring carries the compact chunk."""
    if group == 1:
        return kc
    return torch.repeat_interleave(kc, group, dim=0)


def _collapse_dkv(dk: torch.Tensor, group: int) -> torch.Tensor:
    """Transpose of :func:`_expand_kv`: the ``group`` q-head copies summed
    onto their kv head. [b*nk*group, s, d] -> [b*nk, s, d]."""
    if group == 1:
        return dk
    bh, s, d = dk.shape
    return dk.reshape(bh // group, group, s, d).sum(dim=1)


def _ring_fwd(qs, ks, vs, ex, causal, sm_scale, block_q, block_k, group):
    """The forward ring over the positions ``ex.ranks`` holds: per
    position, (o in q's dtype, lse f32)."""
    cp, s = ex.size, qs[0].shape[1]
    os = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
    lses = [torch.full(q.shape[:2], _NEG_INF, dtype=torch.float32, device=q.device)
            for q in qs]
    cur = list(zip(ks, vs))
    for i in range(cp):
        pending = ex.shift(cur) if i < cp - 1 else None
        for j, my in enumerate(ex.ranks):
            src = (my - i) % cp
            if not _visit_pred(causal, src, my):
                continue
            k_c, v_c = cur[j]
            o_i, lse_i = _flash_fwd(qs[j], _expand_kv(k_c, group), _expand_kv(v_c, group),
                                    my * s, src * s, sm_scale=sm_scale, causal=causal,
                                    block_q=block_q, block_k=block_k)
            os[j], lses[j] = _merge(os[j], lses[j], o_i, lse_i)
        if pending is not None:
            cur = pending.wait()
    return [o.to(q.dtype) for o, q in zip(os, qs)], lses


def _ring_bwd(qs, ks, vs, os, lses, dos, ex, causal, sm_scale, block_q, block_k, group):
    """The backward ring: per position (dq, dk, dv) in the inputs' dtypes.
    Each step posts the next k/v chunk's exchange before its visit; the
    visit's dK/dV join their chunk's running sums, which then move on, so
    the previous step's dK/dV travel during this step's kernels."""
    cp, s = ex.size, qs[0].shape[1]
    stats = [bwd_row_stats(o, lse, do) for o, lse, do in zip(os, lses, dos)]
    dqs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
    dkv = [(torch.zeros(k.shape, dtype=torch.float32, device=k.device),
            torch.zeros(k.shape, dtype=torch.float32, device=k.device)) for k in ks]
    cur = list(zip(ks, vs))
    pend_dkv = None
    for i in range(cp):
        pend_kv = ex.shift(cur) if i < cp - 1 else None
        grads: list = [None] * len(qs)
        for j, my in enumerate(ex.ranks):
            src = (my - i) % cp
            if not _visit_pred(causal, src, my):
                continue
            k_c, v_c = cur[j]
            dq_i, dk_i, dv_i = _flash_bwd(
                qs[j], _expand_kv(k_c, group), _expand_kv(v_c, group), os[j], lses[j],
                dos[j], my * s, src * s, sm_scale=sm_scale, causal=causal,
                block_q=block_q, block_k=block_k, row_stats=stats[j])
            dqs[j] = dqs[j] + dq_i.float()
            grads[j] = (_collapse_dkv(dk_i.float(), group), _collapse_dkv(dv_i.float(), group))
        if pend_dkv is not None:
            dkv = pend_dkv.wait()
        dkv = [(dk + g[0], dv + g[1]) if g is not None else (dk, dv)
               for (dk, dv), g in zip(dkv, grads)]
        # the chunk's sums move on with it: after cp shifts they are home
        pend_dkv = ex.shift(dkv)
        if pend_kv is not None:
            cur = pend_kv.wait()
    dkv = pend_dkv.wait()
    return ([dq.to(q.dtype) for dq, q in zip(dqs, qs)],
            [dk.to(k.dtype) for (dk, _), k in zip(dkv, ks)],
            [dv.to(v.dtype) for (_, dv), v in zip(dkv, vs)])


class _RingAttention(torch.autograd.Function):
    """The ring's custom VJP over the positions the exchange holds: the
    inputs are their q's, then k's, then v's ([bh, s, d] each); the outputs
    their o's."""

    @staticmethod
    def forward(ctx, ex, causal, sm_scale, block_q, block_k, group, *tensors):
        n = len(ex.ranks)
        qs, ks, vs = tensors[:n], tensors[n:2 * n], tensors[2 * n:]
        os, lses = _ring_fwd(qs, ks, vs, ex, causal, sm_scale, block_q, block_k, group)
        ctx.save_for_backward(*qs, *ks, *vs, *os, *lses)
        ctx.cfg = (ex, causal, sm_scale, block_q, block_k, group)
        return tuple(os)

    @staticmethod
    def backward(ctx, *dos):
        ex, causal, sm_scale, block_q, block_k, group = ctx.cfg
        n = len(ex.ranks)
        saved = ctx.saved_tensors
        qs, ks, vs, os, lses = (saved[i * n:(i + 1) * n] for i in range(5))
        dqs, dks, dvs = _ring_bwd(qs, ks, vs, os, lses, [d.contiguous() for d in dos], ex,
                                  causal, sm_scale, block_q, block_k, group)
        return (None,) * 6 + (*dqs, *dks, *dvs)


class LoopbackRing:
    """Every position of a ring of ``size`` in this process: the caller's
    q, k and v are the whole sequence, cut into ``size`` chunks along dim
    2; a shift rotates the chunks in memory (position r receives r − 1's)."""

    def __init__(self, size: int):
        self.size = int(size)

    @property
    def ranks(self) -> tuple:
        return tuple(range(self.size))

    def local(self, x: torch.Tensor) -> list:
        if x.shape[2] % self.size:
            raise ValueError(f"sequence {x.shape[2]} does not cut into {self.size} chunks")
        return list(x.chunk(self.size, dim=2))

    def join(self, parts: list) -> torch.Tensor:
        return torch.cat(parts, dim=2)

    def shift(self, chunks: list) -> "_Arrived":
        return _Arrived(chunks[-1:] + chunks[:-1])


class _Arrived:
    def __init__(self, chunks: list):
        self._chunks = chunks

    def wait(self) -> list:
        return self._chunks


def ring_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *,
    exchange,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    block_q: int = 512,
    block_k: int = 512,
) -> torch.Tensor:
    """Exact attention over a sequence cut along the ring ``exchange``.

    q: ``[batch, heads, seq_local, head_dim]``, this process's part of the
    sequence (its chunk; the whole sequence for a :class:`LoopbackRing`);
    k/v may carry fewer heads (GQA: heads % kv_heads == 0). Positions are
    global: position r of the ring holds rows ``[r·s, (r+1)·s)``. Returns
    the output in q's layout.
    """
    b, h, _, d = q.shape
    nk = k.shape[1]
    if h % nk:
        raise ValueError(f"q heads ({h}) not divisible by kv heads ({nk})")
    if sm_scale is None:
        sm_scale = d ** -0.5
    flat = lambda t, n: t.reshape(b * n, t.shape[2], d).contiguous()  # noqa: E731
    qs = [flat(t, h) for t in exchange.local(q)]
    ks = [flat(t, nk) for t in exchange.local(k)]
    vs = [flat(t, nk) for t in exchange.local(v)]
    os = _RingAttention.apply(exchange, causal, float(sm_scale), block_q, block_k, h // nk,
                              *qs, *ks, *vs)
    return exchange.join([o.reshape(b, h, o.shape[1], d) for o in os])
