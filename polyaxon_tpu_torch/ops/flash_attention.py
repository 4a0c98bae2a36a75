"""Flash attention, forward and backward — port of
``polyaxon_tpu/ops/flash_attention.py``.

Three kernels, each the counterpart of a TPU kernel of the JAX package:

- forward (``csrc/flash_fwd.cu``, replacing ``_fwd_kernel``): O =
  softmax(q·kᵀ·scale)·V with an f32 online softmax over kv tiles and the
  compact f32 LSE; kv tiles past the causal diagonal are never visited.
- dQ (``csrc/flash_bwd.cu``, replacing ``_bwd_dq_kernel``): dQ = Σ dS·K
  over the kv tiles up to the diagonal.
- dK/dV (``csrc/flash_bwd.cu``, replacing ``_bwd_dkv_kernel``): dV = Σ Pᵀ·dO
  and dK = Σ dSᵀ·Q over the q tiles from the first causally visible one.

In bf16 all three are Hopper kernels (``csrc/hopper.cuh``): TMA loads into
an mbarrier-guarded ring, wgmma products, accumulators and the softmax in
registers. In f32 they are CUDA-core kernels that stage every tile in
shared memory.

δ = rowsum(dO∘O) is a plain tensor op outside the kernels
(:func:`bwd_row_stats`), as it is XLA in the JAX package.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the kernel's plain version, a PyTorch tile loop with the
TPU kernel's clamps, masking and dtype roundings at the caller's
``block_q``/``block_k``. There is no fallback from one to the other.

Shapes: q ``[BH, Sq, D]``, k/v ``[BH, Sk, D]`` (K/V already expanded to
every query head), O in q's dtype, LSE and δ f32 ``[BH, Sq]``. The causal
mask compares global positions ``q_offset + i >= k_offset + j``; rows that
see no key get O = 0 and LSE = -inf.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .cuda_build import _Library

#: the TPU kernels' mask value for causally hidden scores (before p = 0)
DEFAULT_MASK_VALUE = -1e30

#: kernel launches, one per CUDA launch of each wrapper — a run resets them
#: and reads them back to show the main path went through the kernels
launch_counts = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}

# pointers, then bh, sq, sk, head_dim, q_offset, k_offset, causal, walk_cut;
# scale; dtype; stream
_DIMS = [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]

_HEADERS = ("flash_common.cuh", "hopper.cuh")
FLASH_FWD_LIB = _Library("flash_fwd", ("flash_fwd.cu",), headers=_HEADERS, signatures={
    # q, k, v, o, lse
    "flash_fwd": ([ctypes.c_void_p] * 5 + _DIMS, ctypes.c_int),
    # head_dim, dtype, int[5] out
    "flash_fwd_resources": ([ctypes.c_int] * 2 + [ctypes.c_void_p], ctypes.c_int),
    "flash_error_string": ([ctypes.c_int], ctypes.c_char_p),
})
FLASH_BWD_LIB = _Library("flash_bwd", ("flash_bwd.cu",), headers=_HEADERS, signatures={
    # q, k, v, do, lse, delta, dq
    "flash_bwd_dq": ([ctypes.c_void_p] * 7 + _DIMS, ctypes.c_int),
    # q, k, v, do, lse, delta, dk, dv
    "flash_bwd_dkv": ([ctypes.c_void_p] * 8 + _DIMS, ctypes.c_int),
    # kernel (0 dQ, 1 dK/dV), head_dim, dtype, int[5] out
    "flash_bwd_resources": ([ctypes.c_int] * 3 + [ctypes.c_void_p], ctypes.c_int),
    "flash_error_string": ([ctypes.c_int], ctypes.c_char_p),
})

KERNEL_HEAD_DIMS = (64, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def kernel_resources(name: str, head_dim: int, dtype: torch.dtype) -> dict:
    """What the kernel ``name`` (a key of :data:`launch_counts`) for
    ``head_dim`` and ``dtype`` holds on the card: registers per thread at
    launch, shared memory per CTA, CTAs per SM, threads per CTA and spilled
    bytes per thread. Needs a CUDA device."""
    out = (ctypes.c_int * 5)()
    code = _KERNEL_DTYPES[dtype]
    if name == "flash_fwd":
        lib = FLASH_FWD_LIB.load()
        rc = lib.flash_fwd_resources(head_dim, code, out)
    else:
        lib = FLASH_BWD_LIB.load()
        rc = lib.flash_bwd_resources(int(name == "flash_bwd_dkv"), head_dim, code, out)
    _raise_on(rc, lib, f"{name} resources")
    return dict(zip(("registers", "smem_bytes", "ctas_per_sm", "threads", "spill_bytes"), out))


def _blocks(sq: int, sk: int, block_q: int, block_k: int) -> tuple[int, int]:
    """The JAX package's block rule: clamp to the lengths, then both must
    divide (``_flash_fwd:157``, ``_flash_bwd:339``)."""
    block_q, block_k = min(block_q, sq), min(block_k, sk)
    if sq % block_q or sk % block_k:
        raise ValueError(f"blocks ({block_q}, {block_k}) must divide the sequence "
                         f"lengths ({sq}, {sk})")
    return block_q, block_k


def _first_q_block(q_offset: int, k_offset: int, s: int, block_q: int,
                   block_k: int) -> int:
    """First q block that causally sees kv block ``s`` (``_q_clamp``)."""
    return max((k_offset + s * block_k - q_offset) // block_q, 0)


def _visible(q_offset, k_offset, j, s, block_q, block_k) -> bool:
    """Does any row of q block ``j`` see any key of kv block ``s``?"""
    return q_offset + (j + 1) * block_q - 1 >= k_offset + s * block_k


# ---------------------------------------------------------------------------
# Plain versions (CPU tensors)
# ---------------------------------------------------------------------------


def flash_fwd_plain(q, k, v, q_offset: int, k_offset: int, *, sm_scale: float,
                    causal: bool, block_q: int, block_k: int):
    """Plain version of the forward kernel: the TPU kernel's walk, one q
    block at a time over the visible kv blocks, with its f32 online
    softmax. Returns (o, lse)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    block_q, block_k = _blocks(sq, sk, block_q, block_k)
    dev = q.device
    o = torch.empty_like(q)
    lse = torch.empty(bh, sq, dtype=torch.float32, device=dev)
    ar_q = torch.arange(block_q, device=dev)
    ar_k = torch.arange(block_k, device=dev)
    for j in range(sq // block_q):
        qb = q[:, j * block_q:(j + 1) * block_q].float()
        q_ids = q_offset + j * block_q + ar_q
        acc = torch.zeros(bh, block_q, d, dtype=torch.float32, device=dev)
        m = torch.full((bh, block_q, 1), float("-inf"), device=dev)
        l = torch.zeros(bh, block_q, 1, device=dev)
        for s in range(sk // block_k):
            if causal and not _visible(q_offset, k_offset, j, s, block_q, block_k):
                break
            kb = k[:, s * block_k:(s + 1) * block_k]
            vb = v[:, s * block_k:(s + 1) * block_k]
            scores = torch.matmul(qb, kb.float().transpose(1, 2)) * sm_scale
            if causal:
                mask = q_ids[:, None] >= (k_offset + s * block_k + ar_k)[None, :]
                scores = torch.where(mask, scores, torch.full_like(scores, DEFAULT_MASK_VALUE))
            m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
            safe_m = torch.where(m_new == float("-inf"), torch.zeros_like(m_new), m_new)
            alpha = torch.where(m == float("-inf"), torch.zeros_like(m), torch.exp(m - safe_m))
            p = torch.exp(scores - safe_m)
            if causal:
                p = torch.where(mask, p, torch.zeros_like(p))
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.matmul(p.to(v.dtype).float(), vb.float())
            m = m_new
        l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
        o[:, j * block_q:(j + 1) * block_q] = (acc / l_safe).to(q.dtype)
        lse[:, j * block_q:(j + 1) * block_q] = torch.where(
            l == 0.0, torch.full_like(l, float("-inf")), m + torch.log(l_safe))[..., 0]
    return o, lse


def _probs_and_ds(qb, kb, vb, dob, lse_b, delta_b, q_ids, k_ids, *, sm_scale,
                  causal, ds_dtype):
    """The backward kernels' shared tile math: P (0 where LSE = -inf or
    masked) and dS = P∘(dO·Vᵀ − δ)·scale rounded to ``ds_dtype``."""
    scores = torch.matmul(qb.float(), kb.float().transpose(1, 2)) * sm_scale
    lse = lse_b[..., None]
    safe_lse = torch.where(lse == float("-inf"), torch.zeros_like(lse), lse)
    p = torch.exp(scores - safe_lse)
    p = torch.where(lse == float("-inf"), torch.zeros_like(p), p)
    if causal:
        p = torch.where(q_ids[:, None] >= k_ids[None, :], p, torch.zeros_like(p))
    dp = torch.matmul(dob.float(), vb.float().transpose(1, 2))
    ds = (p * (dp - delta_b[..., None]) * sm_scale).to(ds_dtype)
    return p, ds


def flash_bwd_dq_plain(q, k, v, do, lse, delta, q_offset: int, k_offset: int, *,
                       sm_scale: float, causal: bool, block_q: int, block_k: int):
    """Plain version of the dQ kernel: per q block, dQ = Σ dS·K over the kv
    blocks up to the diagonal."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    block_q, block_k = _blocks(sq, sk, block_q, block_k)
    dev = q.device
    dq = torch.empty_like(q)
    for j in range(sq // block_q):
        rows = slice(j * block_q, (j + 1) * block_q)
        q_ids = q_offset + j * block_q + torch.arange(block_q, device=dev)
        acc = torch.zeros(bh, block_q, d, dtype=torch.float32, device=dev)
        for s in range(sk // block_k):
            if causal and not _visible(q_offset, k_offset, j, s, block_q, block_k):
                break
            cols = slice(s * block_k, (s + 1) * block_k)
            k_ids = k_offset + s * block_k + torch.arange(block_k, device=dev)
            _, ds = _probs_and_ds(q[:, rows], k[:, cols], v[:, cols], do[:, rows],
                                  lse[:, rows], delta[:, rows], q_ids, k_ids,
                                  sm_scale=sm_scale, causal=causal, ds_dtype=k.dtype)
            acc = acc + torch.matmul(ds.float(), k[:, cols].float())
        dq[:, rows] = acc.to(q.dtype)
    return dq


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, q_offset: int, k_offset: int, *,
                        sm_scale: float, causal: bool, block_q: int, block_k: int):
    """Plain version of the dK/dV kernel: per kv block, dV = Σ Pᵀ·dO and
    dK = Σ dSᵀ·Q over the q blocks from the first causally visible one."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    block_q, block_k = _blocks(sq, sk, block_q, block_k)
    dev = q.device
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    for s in range(sk // block_k):
        cols = slice(s * block_k, (s + 1) * block_k)
        k_ids = k_offset + s * block_k + torch.arange(block_k, device=dev)
        dk_acc = torch.zeros(bh, block_k, d, dtype=torch.float32, device=dev)
        dv_acc = torch.zeros(bh, block_k, d, dtype=torch.float32, device=dev)
        first = _first_q_block(q_offset, k_offset, s, block_q, block_k) if causal else 0
        for j in range(first, sq // block_q):
            rows = slice(j * block_q, (j + 1) * block_q)
            q_ids = q_offset + j * block_q + torch.arange(block_q, device=dev)
            p, ds = _probs_and_ds(q[:, rows], k[:, cols], v[:, cols], do[:, rows],
                                  lse[:, rows], delta[:, rows], q_ids, k_ids,
                                  sm_scale=sm_scale, causal=causal, ds_dtype=q.dtype)
            dv_acc = dv_acc + torch.matmul(p.to(do.dtype).float().transpose(1, 2),
                                           do[:, rows].float())
            dk_acc = dk_acc + torch.matmul(ds.float().transpose(1, 2), q[:, rows].float())
        dk[:, cols] = dk_acc.to(k.dtype)
        dv[:, cols] = dv_acc.to(v.dtype)
    return dk, dv


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def _check_kernel_args(named: dict) -> None:
    """Raise on anything the kernels do not take."""
    q = named["q"]
    if q.device.type != "cuda":
        raise ValueError(f"flash kernels run on CUDA tensors, q is on {q.device}")
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"flash kernels take float32 or bfloat16, got {q.dtype}")
    for name, t in named.items():
        want = torch.float32 if name in ("lse", "delta") else q.dtype
        if t.dtype != want:
            raise TypeError(f"{name} is {t.dtype}, the kernel takes {want}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (the "
                             f"kernels read it in 16-byte vectors)")
    bh, sq, d = q.shape
    sk = named["k"].shape[1]
    shapes = {"k": (bh, sk, d), "v": (bh, sk, d), "do": (bh, sq, d), "lse": (bh, sq),
              "delta": (bh, sq)}
    for name, t in named.items():
        if name in shapes and tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} {tuple(t.shape)} != {shapes[name]}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernels take head_dim in {KERNEL_HEAD_DIMS}, got {d}")


def _raise_on(rc: int, lib, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} "
                           f"({lib.flash_error_string(rc).decode()})")


def _dims(q, k, q_offset, k_offset, sm_scale, causal, walk_cut):
    bh, sq, d = q.shape
    if walk_cut < 0:
        raise ValueError(f"walk_cut must be >= 0, got {walk_cut}")
    return (bh, sq, k.shape[1], d, int(q_offset), int(k_offset), int(bool(causal)),
            int(walk_cut), float(sm_scale), _KERNEL_DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)


# ``walk_cut`` on the three launchers: tiles cut from each CTA's walk. It is
# 0 in use; a check sets it to 1 to plant the fault it must see (the forward
# and dQ stop before the diagonal kv tile, dK/dV starts one q tile late).


def flash_fwd_cuda(q, k, v, q_offset: int, k_offset: int, *, sm_scale: float,
                   causal: bool, walk_cut: int = 0):
    """Launch the forward kernel on the current stream. Returns (o, lse)."""
    _check_kernel_args({"q": q, "k": k, "v": v})
    lib = FLASH_FWD_LIB.load()
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return o, lse
    rc = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                       lse.data_ptr(),
                       *_dims(q, k, q_offset, k_offset, sm_scale, causal, walk_cut))
    _raise_on(rc, lib, "flash_fwd")
    launch_counts["flash_fwd"] += 1
    return o, lse


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, q_offset: int, k_offset: int, *,
                      sm_scale: float, causal: bool, walk_cut: int = 0):
    """Launch the dQ kernel on the current stream."""
    _check_kernel_args({"q": q, "k": k, "v": v, "do": do, "lse": lse, "delta": delta})
    lib = FLASH_BWD_LIB.load()
    dq = torch.empty_like(q)
    if q.numel() == 0:
        return dq
    rc = lib.flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                          lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                          *_dims(q, k, q_offset, k_offset, sm_scale, causal, walk_cut))
    _raise_on(rc, lib, "flash_bwd_dq")
    launch_counts["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, q_offset: int, k_offset: int, *,
                       sm_scale: float, causal: bool, walk_cut: int = 0):
    """Launch the dK/dV kernel on the current stream. Returns (dk, dv)."""
    _check_kernel_args({"q": q, "k": k, "v": v, "do": do, "lse": lse, "delta": delta})
    lib = FLASH_BWD_LIB.load()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if k.numel() == 0:
        return dk, dv
    rc = lib.flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                           lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                           *_dims(q, k, q_offset, k_offset, sm_scale, causal, walk_cut))
    _raise_on(rc, lib, "flash_bwd_dkv")
    launch_counts["flash_bwd_dkv"] += 1
    return dk, dv


# ---------------------------------------------------------------------------
# The JAX package's entry points
# ---------------------------------------------------------------------------


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash attention runs on cuda or cpu tensors, not {t.device}")
    return t.device.type


def _flash_fwd(q, k, v, q_offset=0, k_offset=0, *, sm_scale: float, causal: bool,
               block_q: int, block_k: int):
    """Forward: (o, lse). The blocks are the TPU kernel's tiling; they are
    held to the same divisibility on every device, and the plain version
    walks them, while the CUDA kernel picks its own tiles."""
    _blocks(q.shape[1], k.shape[1], block_q, block_k)
    q_offset, k_offset = int(q_offset), int(k_offset)
    if _device_kind(q) == "cuda":
        return flash_fwd_cuda(q, k, v, q_offset, k_offset, sm_scale=sm_scale,
                              causal=causal)
    return flash_fwd_plain(q, k, v, q_offset, k_offset, sm_scale=sm_scale,
                           causal=causal, block_q=block_q, block_k=block_k)


def bwd_row_stats(o, lse, do):
    """Loop-invariant backward inputs: (lse, delta) with delta =
    rowsum(do*o) in f32, both compact [bh, sq]. Ring attention hoists this
    out of its per-step loop."""
    delta = (do.float() * o.float()).sum(dim=-1)
    return lse, delta


def _flash_bwd(q, k, v, o, lse, do, q_offset=0, k_offset=0, *, sm_scale: float,
               causal: bool, block_q: int, block_k: int, row_stats=None):
    """Backward: (dq, dk, dv) in the dtypes of q, k and v. ``row_stats``
    takes hoisted :func:`bwd_row_stats` output."""
    _blocks(q.shape[1], k.shape[1], block_q, block_k)
    q_offset, k_offset = int(q_offset), int(k_offset)
    lse_c, delta_c = row_stats if row_stats is not None else bwd_row_stats(o, lse, do)
    args = (q, k, v, do, lse_c.contiguous(), delta_c.contiguous(), q_offset, k_offset)
    if _device_kind(q) == "cuda":
        dq = flash_bwd_dq_cuda(*args, sm_scale=sm_scale, causal=causal)
        dk, dv = flash_bwd_dkv_cuda(*args, sm_scale=sm_scale, causal=causal)
        return dq, dk, dv
    blocks = dict(sm_scale=sm_scale, causal=causal, block_q=block_q, block_k=block_k)
    dq = flash_bwd_dq_plain(*args, **blocks)
    dk, dv = flash_bwd_dkv_plain(*args, **blocks)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """``_make_flash``'s custom VJP: the forward saves q, k, v, o and lse;
    the backward computes δ and runs the dQ and dK/dV kernels. The offsets
    and block settings get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, k_offset, sm_scale, causal, block_q,
                block_k, block_q_bwd, block_k_bwd):
        o, lse = _flash_fwd(q, k, v, q_offset, k_offset, sm_scale=sm_scale,
                            causal=causal, block_q=block_q, block_k=block_k)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = (q_offset, k_offset, sm_scale, causal, block_q_bwd, block_k_bwd)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        q_offset, k_offset, sm_scale, causal, block_q, block_k = ctx.cfg
        dq, dk, dv = _flash_bwd(q, k, v, o, lse, do.contiguous(), q_offset, k_offset,
                                sm_scale=sm_scale, causal=causal, block_q=block_q,
                                block_k=block_k)
        return dq, dk, dv, None, None, None, None, None, None, None, None


def flash_attention_bhsd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    q_offset=0,
    k_offset=0,
    block_q: int = 512,
    block_k: int = 512,
    block_q_bwd: Optional[int] = None,
    block_k_bwd: Optional[int] = None,
    return_lse: bool = False,
):
    """Flash attention over ``[batch*heads, seq, head_dim]`` tensors.

    ``q_offset``/``k_offset`` are the global sequence positions of element
    0 of the q/k chunks (ints): the causal mask compares global positions.
    ``block_q_bwd``/``block_k_bwd`` are the backward's blocks (None = the
    forward's). With ``return_lse`` it returns (o, lse) and records no
    gradient, as the JAX function does.
    """
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if return_lse:
        return _flash_fwd(q, k, v, q_offset, k_offset, sm_scale=float(sm_scale),
                          causal=causal, block_q=block_q, block_k=block_k)
    return _FlashAttention.apply(q, k, v, int(q_offset), int(k_offset), float(sm_scale),
                                 causal, block_q, block_k, block_q_bwd or block_q,
                                 block_k_bwd or block_k)
