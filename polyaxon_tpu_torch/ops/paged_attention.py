"""Paged (blocked-KV) decode attention over a block pool — port of
``polyaxon_tpu/ops/paged_attention.py``.

Two implementations behind one signature:

- ``impl="gather"`` — gather each row's blocks into a contiguous cache and
  run the masked dense math of :func:`dense_decode_attention`. Plain
  PyTorch on any device.
- ``impl="flash"`` — :func:`paged_decode`: on a CUDA tensor the hand-written
  kernels of ``csrc/paged_decode.cu`` (replacing the TPU kernel
  ``_decode_kernel``), which walk each row's block table up to its length
  with an f32 online softmax (in bf16 the walk is split over CTAs of 256
  tokens and their partials merged by a second kernel); on a CPU tensor its
  plain version :func:`paged_decode_plain`, the same walk as a
  block-by-block tile loop.

Shapes (G = query heads per KV head, GQA):
    q           [B, KVH, G, D]    one decode token per sequence
    k/v pool    [N, bs, KVH, D]   one layer of the shared block pool
    block_tables[B, T] int32      pool indices, row-padded with 0
    lengths     [B]   int32       live tokens per sequence (0 = idle slot)

Tables may alias blocks across rows (prefix sharing): both paths only
read the pool.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .cuda_build import _Library

#: the TPU kernel's mask value for dead key slots (before p is zeroed)
MASK_VALUE = -1e30

#: kernel launches, one per CUDA launch of the wrapper — a run resets it
#: and reads it back to show the main path went through the kernel
launch_counts = {"paged_decode": 0}

PAGED_DECODE_LIB = _Library(
    "paged_decode", ("paged_decode.cu",), headers=("flash_common.cuh", "hopper.cuh"),
    signatures={
        # q, k_pool, v_pool, tables, lengths, out, part_acc, part_ml; batch,
        # kv_heads, groups, head_dim, num_blocks, block_size, max_blocks,
        # splits; sm_scale; dtype; stream
        "paged_decode": ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                         + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
                         ctypes.c_int),
        # head_dim, dtype, int[5] out
        "paged_decode_resources": ([ctypes.c_int] * 2 + [ctypes.c_void_p], ctypes.c_int),
        "paged_decode_split_tokens": ([], ctypes.c_int),
        "paged_decode_error_string": ([ctypes.c_int], ctypes.c_char_p),
    })

#: query heads per KV head the kernels take (their shared-memory sizing)
KERNEL_MAX_GROUPS = 8
KERNEL_HEAD_DIMS = (64, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: the bf16 walk's f32 workspace, one flat buffer per (device, stream)
_workspaces: dict = {}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def split_tokens() -> int:
    """Tokens per CTA of the bf16 kernel's split walk, as the kernel
    library reports it. Needs a CUDA device."""
    return PAGED_DECODE_LIB.load().paged_decode_split_tokens()


def split_workspace(batch: int, kv_heads: int, groups: int, head_dim: int,
                    max_blocks: int, block_size: int,
                    tokens_per_split: int) -> tuple[int, tuple, tuple]:
    """The bf16 kernel's split walk for a table of ``max_blocks`` blocks of
    ``block_size`` tokens: the number of splits (CTAs of
    ``tokens_per_split`` tokens that cover the table's capacity) and the
    shapes of its f32 workspace, each split's unnormalised accumulator and
    its (m, l)."""
    splits = -(-max_blocks * block_size // tokens_per_split)
    return (splits, (batch, kv_heads, splits, groups, head_dim),
            (batch, kv_heads, splits, groups, 2))


def workspace(device: torch.device, stream: int, numel: int) -> torch.Tensor:
    """``numel`` f32 elements of the buffer kept for ``stream`` on
    ``device``, grown when a call needs more. Calls on one stream run in
    order, so each reuses the buffer the previous one is done with, and a
    decode step's layers allocate nothing."""
    buf = _workspaces.get((device, stream))
    if buf is None or buf.numel() < numel:
        buf = torch.empty(numel, dtype=torch.float32, device=device)
        _workspaces[(device, stream)] = buf
    return buf[:numel]


def kernel_resources(head_dim: int, dtype: torch.dtype) -> dict:
    """What the kernel for ``head_dim`` and ``dtype`` (bf16: the split
    kernel) holds on the card: registers per thread at launch, shared
    memory per CTA, CTAs per SM, threads per CTA and spilled bytes per
    thread. Needs a CUDA device."""
    out = (ctypes.c_int * 5)()
    lib = PAGED_DECODE_LIB.load()
    rc = lib.paged_decode_resources(head_dim, _KERNEL_DTYPES[dtype], out)
    if rc != 0:
        raise RuntimeError(f"paged_decode resources failed: CUDA error {rc} "
                           f"({lib.paged_decode_error_string(rc).decode()})")
    return dict(zip(("registers", "smem_bytes", "ctas_per_sm", "threads", "spill_bytes"), out))


def dense_decode_attention(
    q: torch.Tensor,          # [B, KVH, G, D]
    k_cache: torch.Tensor,    # [B, C, KVH, D]
    v_cache: torch.Tensor,    # [B, C, KVH, D]
    lengths: torch.Tensor,    # [B] int
    *,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Decode attention over a contiguous per-sequence cache: f32 math
    regardless of storage dtype; fully-masked rows (length 0) are zeros."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    scores = torch.einsum(
        "bhgd,bchd->bhgc", q.float(), k_cache.float()) * sm_scale
    k_ids = torch.arange(k_cache.shape[1], device=q.device)
    mask = k_ids[None, :] < lengths.to(q.device).long()[:, None]   # [B, C]
    scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0)                        # idle slots
    return torch.einsum(
        "bhgc,bchd->bhgd", probs, v_cache.float()).to(q.dtype)


def gather_blocks(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """[N, bs, KVH, D] pool + [B, T] tables -> [B, T*bs, KVH, D]."""
    b, t = block_tables.shape
    _, bs, kvh, d = pool.shape
    return pool[block_tables.long()].reshape(b, t * bs, kvh, d)


def paged_decode_plain(q, k_pool, v_pool, block_tables, lengths, *,
                       sm_scale: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel: walk the tables block by block
    (all rows at once) with the TPU kernel's f32 online softmax, masking
    and zero-length handling. Runs on any device; the wrapper takes it only
    for CPU tensors."""
    b, kvh, g, d = q.shape
    _, bs, _, _ = k_pool.shape
    t = block_tables.shape[1]
    dev = q.device
    tables = block_tables.to(dev).long()
    lens = lengths.to(dev).long().clamp(0, t * bs)
    qf = q.float()
    acc = torch.zeros(b, kvh, g, d, dtype=torch.float32, device=dev)
    m = torch.full((b, kvh, g, 1), float("-inf"), device=dev)
    l = torch.zeros(b, kvh, g, 1, device=dev)
    steps = min(t, -(-int(lens.max()) // bs)) if b else 0
    offs = torch.arange(bs, device=dev)
    for s in range(steps):
        run = (s * bs < lens)[:, None, None, None]                 # [B,1,1,1]
        k = k_pool[tables[:, s]]                                    # [B,bs,KVH,D]
        v = v_pool[tables[:, s]]
        scores = torch.einsum("bhgd,bthd->bhgt", qf, k.float()) * sm_scale
        live = (s * bs + offs)[None, :] < lens[:, None]             # [B, bs]
        live = live[:, None, None, :]
        scores = torch.where(live, scores, torch.full_like(scores, MASK_VALUE))
        m_cur = scores.amax(dim=-1, keepdim=True)
        m_new = torch.maximum(m, m_cur)
        safe_m = torch.where(m_new == float("-inf"), torch.zeros_like(m_new), m_new)
        alpha = torch.where(m == float("-inf"), torch.zeros_like(m),
                            torch.exp(m - safe_m))
        p = torch.exp(scores - safe_m)
        p = torch.where(live, p, torch.zeros_like(p))
        l_new = alpha * l + p.sum(dim=-1, keepdim=True)
        pv = torch.einsum("bhgt,bthd->bhgd", p.to(v.dtype).float(), v.float())
        acc = torch.where(run, acc * alpha + pv, acc)
        m = torch.where(run, m_new, m)
        l = torch.where(run, l_new, l)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l_safe).to(q.dtype)


def _check_kernel_args(q, k_pool, v_pool, block_tables, lengths):
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"paged_decode kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"pools ({k_pool.dtype}, {v_pool.dtype}) must have "
                        f"q's dtype {q.dtype}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_tables and lengths must be int32")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.ndim != 4 or k_pool.ndim != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"q {tuple(q.shape)} must be [B, KVH, G, D] and the "
                         f"pools [N, bs, KVH, D]: {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)}")
    b, kvh, g, d = q.shape
    if k_pool.shape[2] != kvh or k_pool.shape[3] != d:
        raise ValueError(f"pool heads/dim {tuple(k_pool.shape[2:])} != "
                         f"q's ({kvh}, {d})")
    if block_tables.ndim != 2 or block_tables.shape[0] != b \
            or tuple(lengths.shape) != (b,):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} must be "
                         f"[B, T] and lengths {tuple(lengths.shape)} [B], B={b}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (the "
                             f"kernel reads it in 16-byte vectors)")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"paged_decode kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    if not 1 <= g <= KERNEL_MAX_GROUPS:
        raise ValueError(f"paged_decode kernel takes 1..{KERNEL_MAX_GROUPS} "
                         f"query heads per KV head, got {g}")


def paged_decode_cuda(q, k_pool, v_pool, block_tables, lengths, *,
                      sm_scale: float) -> torch.Tensor:
    """Launch the CUDA kernels on the current stream (builds the library at
    first use); in bf16 the split walk's workspace comes from
    :func:`split_workspace`, kept per stream by :func:`workspace`. Raises on anything the kernels do not take, and
    when a launch is refused."""
    _check_kernel_args(q, k_pool, v_pool, block_tables, lengths)
    lib = PAGED_DECODE_LIB.load()
    out = torch.empty_like(q)
    b, kvh, g, d = q.shape
    if b == 0 or kvh == 0:
        return out
    n, bs = k_pool.shape[0], k_pool.shape[1]
    t = block_tables.shape[1]
    splits, acc_shape, ml_shape = split_workspace(b, kvh, g, d, t, bs,
                                                  lib.paged_decode_split_tokens())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    part_acc = part_ml = None
    if q.dtype == torch.bfloat16:
        n_acc, n_ml = math.prod(acc_shape), math.prod(ml_shape)
        buf = workspace(q.device, stream, n_acc + n_ml)
        part_acc, part_ml = buf[:n_acc], buf[n_acc:]
    rc = lib.paged_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        None if part_acc is None else part_acc.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(),
        b, kvh, g, d, n, bs, t, splits, float(sm_scale),
        _KERNEL_DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(
            f"paged_decode launch failed: CUDA error {rc} "
            f"({lib.paged_decode_error_string(rc).decode()})")
    launch_counts["paged_decode"] += 1
    return out


def paged_decode(q, k_pool, v_pool, block_tables, lengths, *,
                 sm_scale: Optional[float] = None) -> torch.Tensor:
    """The ``flash`` path: the CUDA kernel for CUDA tensors, its plain
    version for CPU tensors. There is no fallback from one to the other."""
    if sm_scale is None:
        sm_scale = float(q.shape[-1] ** -0.5)
    if q.device.type == "cuda":
        return paged_decode_cuda(q, k_pool, v_pool, block_tables, lengths,
                                 sm_scale=sm_scale)
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pool, v_pool, block_tables, lengths,
                                  sm_scale=sm_scale)
    raise ValueError(f"paged_decode runs on cuda or cpu tensors, "
                     f"not {q.device}")


def paged_attention(
    q: torch.Tensor,             # [B, KVH, G, D]
    k_pool: torch.Tensor,        # [N, bs, KVH, D]
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # [B, T] int32
    lengths: torch.Tensor,       # [B] int32
    *,
    sm_scale: Optional[float] = None,
    impl: str = "gather",
) -> torch.Tensor:
    """Decode attention over a paged KV pool. Returns [B, KVH, G, D]."""
    if sm_scale is None:
        sm_scale = float(q.shape[-1] ** -0.5)
    if impl == "gather":
        k = gather_blocks(k_pool, block_tables)
        v = gather_blocks(v_pool, block_tables)
        return dense_decode_attention(q, k, v, lengths, sm_scale=sm_scale)
    if impl == "flash":
        return paged_decode(q, k_pool, v_pool, block_tables, lengths,
                            sm_scale=sm_scale)
    raise ValueError(f"unknown paged attention impl {impl!r}; "
                     f"valid: gather|flash")
