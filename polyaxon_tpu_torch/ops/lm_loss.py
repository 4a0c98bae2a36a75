"""The LM head's cross entropy with its gradient formed in the forward pass
(fused linear cross entropy).

Per loss call the head weight is cast once into a zero-padded buffer of
``round_up(vocab, 128)`` rows in the activation dtype, so every row of a
chunk's logits starts on a 16-byte boundary and the head's three products
run on aligned GEMMs. Per chunk of rows:

1. ``logits = x_c @ W_pᵀ`` (``torch.matmul``, a plain large product);
2. one launch of the row kernel (``csrc/lm_loss.cu``, replacing no TPU
   kernel: the JAX package's loss is plain ``jnp``) reads each row once,
   writes the rows' losses and overwrites the logits with the gradient
   ``(softmax − onehot(label)) · mask · scale``, ``scale`` = 1 / the
   batch's token count, which stays on the device;
3. ``dx_c = dlogits @ W_p`` and ``dW += dlogits_cᵀ @ x_c`` (in f32).

The forward returns the loss and keeps ``dx`` and ``dW``; the backward
only scales them by the incoming gradient, so nothing is recomputed.

On a CUDA tensor the row function launches the kernel or raises; on a CPU
tensor it runs :func:`lm_loss_rows_plain`, the kernel's plain version.
There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .cuda_build import _Library

#: a chunk's logits are this many columns wide at a multiple (16-byte rows
#: in bf16 and f32, and the head's GEMMs on aligned kernels)
VOCAB_ALIGN = 128

#: kernel launches, one per CUDA launch of the row function — reset before
#: a run and read after it to show the main path went through the kernel
launch_counts = {"lm_loss": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


LM_LOSS_LIB = _Library("lm_loss", ("lm_loss.cu",), headers=("flash_common.cuh",), signatures={
    # logits, labels, mask, scale, loss; rows, vocab, vp, grad, dtype; stream
    "lm_loss_rows": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
                     ctypes.c_int),
    # vp, dtype, int[5] out
    "lm_loss_resources": ([ctypes.c_int] * 2 + [ctypes.c_void_p], ctypes.c_int),
    "lm_loss_error_string": ([ctypes.c_int], ctypes.c_char_p),
})

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def padded_vocab(vocab: int) -> int:
    return -(-vocab // VOCAB_ALIGN) * VOCAB_ALIGN


def kernel_resources(vp: int, dtype: torch.dtype) -> dict:
    """What the row kernel for rows of ``vp`` columns in ``dtype`` holds on
    the card with the gradient: registers per thread, shared memory per
    CTA, CTAs per SM, threads per CTA and spilled bytes per thread. Needs a
    CUDA device."""
    out = (ctypes.c_int * 5)()
    lib = LM_LOSS_LIB.load()
    _raise_on(lib.lm_loss_resources(vp, _KERNEL_DTYPES[dtype], out), lib, "lm_loss resources")
    return dict(zip(("registers", "smem_bytes", "ctas_per_sm", "threads", "spill_bytes"), out))


def lm_loss_rows_plain(logits, labels, mask, scale, vocab: int, *, grad: bool, out):
    """Plain version of the row kernel: ``out`` [rows] f32 gets each row's
    ``mask · (logsumexp − gold)`` over the first ``vocab`` columns (0 where
    the mask is 0, NaN for a label outside the vocabulary); with ``grad``
    the logits are overwritten in place by the gradient, zeros in the pad
    and in rows whose mask is 0."""
    z = logits[:, :vocab].float()
    weight = torch.ones_like(out) if mask is None else mask
    live = weight != 0
    inside = (labels >= 0) & (labels < vocab)
    m = z.amax(dim=-1, keepdim=True)
    e = torch.exp(z - m)
    total = e.sum(dim=-1, keepdim=True)
    gold = torch.gather(z, -1, labels.clamp(0, vocab - 1)[:, None])
    nll = torch.where(inside, (m + torch.log(total) - gold)[:, 0], float("nan"))
    out.copy_(torch.where(live, weight * nll, 0.0))
    if grad:
        coef = (weight * scale)[:, None]
        g = e / total * coef
        g.scatter_add_(-1, labels.clamp(0, vocab - 1)[:, None],
                       torch.where(inside[:, None], -coef, 0.0))
        logits[:, :vocab] = torch.where(live[:, None], g, 0.0).to(logits.dtype)
        logits[:, vocab:] = 0
    return out


def _raise_on(rc: int, lib, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} "
                           f"({lib.lm_loss_error_string(rc).decode()})")


def lm_loss_rows_cuda(logits, labels, mask, scale, vocab: int, *, grad: bool, out):
    """Launch the row kernel on the current stream (see
    :func:`lm_loss_rows_plain` for what it computes)."""
    if logits.device.type != "cuda":
        raise ValueError(f"the lm_loss kernel runs on CUDA tensors, logits are on "
                         f"{logits.device}")
    if logits.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the lm_loss kernel takes float32 or bfloat16 logits, got "
                        f"{logits.dtype}")
    named = {"logits": (logits, logits.dtype), "labels": (labels, torch.int64),
             "scale": (scale, torch.float32), "loss": (out, torch.float32)}
    if mask is not None:
        named["mask"] = (mask, torch.float32)
    for name, (t, dtype) in named.items():
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, the kernel takes {dtype}")
        if t.device != logits.device:
            raise ValueError(f"{name} is on {t.device}, logits on {logits.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    rows, vp = logits.shape
    if vp % VOCAB_ALIGN or not 0 < vocab <= vp:
        raise ValueError(f"logits of {vp} columns for a vocabulary of {vocab}: the kernel "
                         f"takes a multiple of {VOCAB_ALIGN} columns at or above it")
    if logits.data_ptr() % 16:
        raise ValueError("logits must start on a 16-byte boundary (the kernel reads them "
                         "in 16-byte vectors)")
    for name in ("labels", "mask", "loss"):
        if name in named and tuple(named[name][0].shape) != (rows,):
            raise ValueError(f"{name} {tuple(named[name][0].shape)} != ({rows},)")
    if scale.numel() != 1:
        raise ValueError(f"scale holds {scale.numel()} values, the kernel reads one")
    if rows == 0:
        return out
    lib = LM_LOSS_LIB.load()
    rc = lib.lm_loss_rows(logits.data_ptr(), labels.data_ptr(),
                          None if mask is None else mask.data_ptr(), scale.data_ptr(),
                          out.data_ptr(), rows, vocab, vp, int(grad),
                          _KERNEL_DTYPES[logits.dtype],
                          torch.cuda.current_stream(logits.device).cuda_stream)
    _raise_on(rc, lib, "lm_loss")
    launch_counts["lm_loss"] += 1
    return out


def lm_loss_rows(logits, labels, mask, scale, vocab: int, *, grad: bool, out):
    """The row kernel on a CUDA tensor, its plain version on a CPU one."""
    fn = lm_loss_rows_cuda if logits.device.type == "cuda" else lm_loss_rows_plain
    return fn(logits, labels, mask, scale, vocab, grad=grad, out=out)


class _FusedLMLoss(torch.autograd.Function):
    """The loss and, in the same forward, the gradients of ``x`` and ``w``
    that the flags ask for; the backward scales them by its incoming
    gradient. The labels, mask and settings get no gradient."""

    @staticmethod
    def forward(ctx, x, w, labels, mask, vocab_major, chunks, mesh, need_dx, need_dw):
        b, s, h = x.shape
        n = b * s
        vocab = w.shape[0] if vocab_major else w.shape[1]
        vp = padded_vocab(vocab)
        xf = x.reshape(n, h)
        labels = labels.reshape(n).long()
        mask = None if mask is None else mask.reshape(n).float()
        count = (torch.full((), float(n), device=x.device) if mask is None else mask.sum())
        if mesh is not None:
            count = mesh.batch_count(count)
        count = torch.clamp(count, min=1.0)
        scale = (1.0 / count).reshape(1)
        wp = x.new_empty(vp, h)
        wp[:vocab].copy_(w if vocab_major else w.t())
        wp[vocab:].zero_()
        rows = n // chunks
        logits = x.new_empty(rows, vp)
        row_loss = torch.empty(n, dtype=torch.float32, device=x.device)
        dx = x.new_empty(n, h) if need_dx else None
        dw = None
        for c in range(chunks):
            sl = slice(c * rows, (c + 1) * rows)
            xc = xf[sl]
            torch.matmul(xc, wp.t(), out=logits)
            lm_loss_rows(logits, labels[sl], None if mask is None else mask[sl], scale, vocab,
                         grad=need_dx or need_dw, out=row_loss[sl])
            if need_dx:
                torch.matmul(logits, wp, out=dx[sl])
            if need_dw:
                part = torch.matmul(logits.t(), xc)
                dw = part.float() if dw is None else dw.add_(part)
        if dw is not None:
            dw = dw[:vocab] if vocab_major else dw[:vocab].t()
        ctx.save_for_backward(dx, dw)
        ctx.x_shape = x.shape
        return row_loss.sum() / count

    @staticmethod
    def backward(ctx, g):
        dx, dw = ctx.saved_tensors
        gx = None if dx is None else (dx * g).reshape(ctx.x_shape)
        gw = None if dw is None else dw * g
        return gx, gw, None, None, None, None, None, None, None


def fused_lm_loss(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None, *, vocab_major: bool, chunks: int,
                  mesh=None) -> torch.Tensor:
    """The mean token (or mask-weighted) NLL of ``x`` [batch, seq, hidden]
    under the head ``w`` ([vocab, hidden] when ``vocab_major``, else
    [hidden, vocab]) over ``chunks`` equal chunks of the batch's rows, with
    the gradients formed in the forward. With a ``mesh`` (no ``model``
    axis) the count is the whole batch's, as ``mesh.batch_count`` gives it.
    Gradients are formed only for what requires one under grad mode."""
    grad = torch.is_grad_enabled()
    return _FusedLMLoss.apply(x, w, labels, mask, vocab_major, chunks, mesh,
                              grad and x.requires_grad, grad and w.requires_grad)
