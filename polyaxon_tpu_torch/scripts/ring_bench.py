"""Ring attention against the all-gather it replaces, forward only.

    python -m polyaxon_tpu_torch.scripts.ring_bench [--seq 8192,16384] [--cp N]
        [--platform cuda|cpu]
    torchrun --nproc-per-node N -m polyaxon_tpu_torch.scripts.ring_bench [--platform cpu]

The port's twin of the repository's ``scripts/ring_bench.py``. For each
sequence length it times two schedules of the same causal attention over
a ring of ``cp`` positions, each position holding its chunk of q:

- ring: :func:`~..ops.ring_attention.ring_attention`, whose K/V chunks
  travel the ring, one flash forward (B1) per visit;
- gather: the strawman the ring replaces. Every position holds the whole
  sequence's K and V and runs one flash forward of its q chunk at its
  global offset.

Alone, the ring is a :class:`~..ops.ring_attention.LoopbackRing` that holds
every position in this process (``--cp``, default 8), and the gather path
takes the whole tensors. Started as one of W ranks (``torchrun`` or the
``PLX_*`` env), the ring is the ``context`` group's
:class:`~..parallel.collectives.RingExchange` with cp = W, and the gather
path all-gathers K and V over it (NCCL on cuda, one GPU a rank; gloo on
the CPU). Both paths compute the same function: the tool asserts that
their outputs agree within :data:`AGREE_TOL` of the output's largest
element.

Shapes are the JAX script's (batch 1, 4 heads, head dim 64, blocks of
512); :func:`run_ring_bench` takes others (``chip_smoke.py`` runs
llama-1b's 32 q heads over 4 kv heads). The inputs are f32 on the CPU, as
the JAX script draws them, and bf16 on cuda, the dtype every model of the
zoo feeds B1 in. Times are the host clock's mean over ``steps`` calls
after a warm one, each call closed by a device sync and a fetch of one
element, as the JAX script times them.

Rank 0 prints one JSON line per sequence length with the JAX script's
keys, ``v5e_`` renamed ``h100_``: the per-step compute and exchange time
of llama-1b's ring (32 q heads, 4 kv heads, D 64, the causal average of
half a chunk pair, the compact bf16 K/V chunk) at the H100's data-sheet
peaks, and their ratio (above 1: compute can cover the exchange), plus
``platform``, ``dtype`` and ``ranks`` (1 for the loopback ring).
``kv_resident_mb_ring`` and ``kv_resident_mb_gather`` keep the JAX
script's formula, which counts 2 bytes an element whatever the dtype, and
its rounding to two places.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Optional, Sequence

import torch

from ..bench import require_platform

# H100 SXM data-sheet peaks: dense bf16 tensor-core FLOP/s, and NVLink 4's
# 900 GB/s bidirectional as one direction's bytes per second
H100_BF16_FLOPS = 989e12
H100_NVLINK_BYTES_PER_S = 450e9

#: the JAX script's shapes and flash blocks
BATCH, HEADS, HEAD_DIM, BLOCK = 1, 4, 64, 512
#: ring against gather, normwise: max |ring - gather| <= tol x max |gather|.
#: bf16 is chip_smoke.py's RING_TOL (the ring rounds each visit's partial
#: output to bf16 before its f32 merge, the gather path rounds once); f32
#: sums the same products in another order
AGREE_TOL = {torch.bfloat16: 2.0 ** -6, torch.float32: 1e-5}
#: llama-1b's attention, which the analytic columns price
LLAMA1B_HEADS, LLAMA1B_KV_HEADS, LLAMA1B_HEAD_DIM = 32, 4, 64


def gather_q_offset(index: int, s_l: int) -> int:
    """The global row of position ``index``'s first query: its chunk's."""
    return index * s_l


def make_inputs(seq: int, *, batch: int, heads: int, kv_heads: int, head_dim: int,
                dtype: torch.dtype, device) -> tuple:
    """The whole sequence's q ``[batch, heads, seq, head_dim]`` and k, v
    ``[batch, kv_heads, seq, head_dim]``: standard normals times 0.1 from
    one generator seeded 0, drawn in f32 and cast."""
    gen = torch.Generator(device=device).manual_seed(0)
    shapes = ((batch, heads, seq, head_dim),) + ((batch, kv_heads, seq, head_dim),) * 2
    return tuple((torch.randn(s, generator=gen, device=device) * 0.1).to(dtype)
                 for s in shapes)


def ring_forward(q, k, v, exchange) -> torch.Tensor:
    """The ring path: this process's output (the whole sequence on a
    loopback ring, its chunk on a group's)."""
    from ..ops.ring_attention import ring_attention

    with torch.no_grad():
        return ring_attention(q, k, v, exchange=exchange, causal=True, block_q=BLOCK,
                              block_k=BLOCK)


def _of_group(exchange) -> bool:
    """Whether ``exchange`` is a process group's ring (one position here)."""
    from ..parallel.collectives import RingExchange

    return isinstance(exchange, RingExchange)


def _gathered(t: torch.Tensor, exchange) -> torch.Tensor:
    """The whole sequence of ``t`` (a group's chunk): all-gathered over the
    ring's group, in position order."""
    from ..parallel import collectives

    rows = collectives.gather_rows(t, exchange.group, exchange.size)
    return torch.cat(list(rows.unbind(0)), dim=2)


def gather_forward(q, k, v, exchange) -> torch.Tensor:
    """The gather path: each position holds all of K and V and runs one
    flash forward (B1) of its q chunk at :func:`gather_q_offset`, key
    offset 0, causal. Same layout as :func:`ring_forward`'s output."""
    from ..ops.flash_attention import _flash_fwd
    from ..ops.ring_attention import _expand_kv

    b, h, _, d = q.shape
    nk = k.shape[1]
    if _of_group(exchange):
        k, v = _gathered(k, exchange), _gathered(v, exchange)
    flat = lambda t, n: t.reshape(b * n, t.shape[2], d).contiguous()  # noqa: E731
    kf, vf = (_expand_kv(flat(t, nk), h // nk) for t in (k, v))
    outs = []
    with torch.no_grad():
        for index, qc in zip(exchange.ranks, exchange.local(q)):
            s_l = qc.shape[2]
            o, _ = _flash_fwd(flat(qc, h), kf, vf, gather_q_offset(index, s_l), 0,
                              sm_scale=d ** -0.5, causal=True, block_q=BLOCK,
                              block_k=BLOCK)
            outs.append(o.reshape(b, h, s_l, d))
    return exchange.join(outs)


def agreement(out: torch.Tensor, ref: torch.Tensor, exchange=None) -> float:
    """max |out - ref| / max |ref| over the whole ring (a group's ranks
    agree on it)."""
    err = (out.float() - ref.float()).abs().max().reshape(1)
    top = ref.float().abs().max().reshape(1)
    if exchange is not None and _of_group(exchange):
        from ..parallel import collectives

        collectives.max_over(err, exchange.group)
        collectives.max_over(top, exchange.group)
    return (err / top).item()


def time_path(fn: Callable[[], torch.Tensor], steps: int) -> tuple:
    """(the warm call's output, the mean ms of ``steps`` calls after it on
    the host clock, each closed by a sync and a one-element fetch)."""
    out = fn()
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(steps):
        o = fn()
        _sync(o)
    return out, (time.perf_counter() - t0) / steps * 1000.0


def _sync(out: torch.Tensor) -> None:
    if out.is_cuda:
        torch.cuda.synchronize(out.device)
    float(out.reshape(-1)[0])


def analytic(seq: int, cp: int) -> dict:
    """The JAX script's per-step analytics at llama-1b's attention, at the
    H100's peaks."""
    s_l = seq // cp
    step_flops = 4 * 1 * LLAMA1B_HEADS * s_l * s_l * LLAMA1B_HEAD_DIM * 0.5
    step_bytes = 2 * 2 * 1 * LLAMA1B_KV_HEADS * s_l * LLAMA1B_HEAD_DIM
    compute_s = step_flops / H100_BF16_FLOPS
    comm_s = step_bytes / H100_NVLINK_BYTES_PER_S
    return {"h100_step_compute_us_llama1b": compute_s * 1e6,
            "h100_step_comm_us_llama1b_gqa_compact": comm_s * 1e6,
            "h100_compute_over_comm": compute_s / comm_s}


def bench_row(seq: int, cp: int, *, batch: int, heads: int, head_dim: int,
              ring_ms: float, gather_ms: float, platform: str, dtype: torch.dtype,
              ranks: int) -> dict:
    """One line: the JAX script's keys (``v5e_`` as ``h100_``) and the
    port's ``platform``, ``dtype`` and ``ranks``."""
    kv_full_mb = 2 * 2 * batch * heads * seq * head_dim / 1e6
    return {
        "seq": seq, "cp": cp, "b": batch, "heads": heads, "head_dim": head_dim,
        "ring_fwd_ms": ring_ms, "gather_fwd_ms": gather_ms,
        "ring_over_gather": ring_ms / gather_ms,
        "kv_resident_mb_ring": round(kv_full_mb / cp, 2),
        "kv_resident_mb_gather": round(kv_full_mb, 2),
        **analytic(seq, cp),
        "platform": platform, "dtype": str(dtype).replace("torch.", ""), "ranks": ranks,
    }


def ring_of(cp: Optional[int], device) -> tuple:
    """(the exchange, cp): a loopback ring of ``cp`` (8 when None) alone;
    the ``context`` group's ring of every rank under a process group,
    where a ``cp`` other than the world size is an error."""
    from .. import parallel
    from ..ops.ring_attention import LoopbackRing

    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        cp = 8 if cp is None else int(cp)
        return LoopbackRing(cp), cp
    world = dist.get_world_size()
    if cp is not None and int(cp) != world:
        raise ValueError(f"--cp {cp} differs from the {world} ranks of the process group: "
                         f"a ring of ranks holds one position a rank (cp = {world})")
    mesh = parallel.build_mesh({"context": world})
    return mesh.ring(), world


def run_ring_bench(seqs: Sequence[int] = (8192, 16384), cp: Optional[int] = None, *,
                   batch: int = BATCH, heads: int = HEADS, kv_heads: Optional[int] = None,
                   head_dim: int = HEAD_DIM, platform: str = "cuda",
                   steps: int = 3) -> list:
    """One row per sequence length (:func:`bench_row`), after asserting
    that the ring's output agrees with the gather path's. The process
    joins the env's process group first (and leaves a group it joined);
    under a group each rank holds its chunk of the same seeded inputs."""
    from .. import parallel
    from ..runtime.builtin import resolve_device

    device = resolve_device({"platform": platform})
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    kv_heads = heads if kv_heads is None else int(kv_heads)
    rows = []
    with parallel.joined_group(device):
        exchange, cp = ring_of(cp, device)
        for seq in seqs:
            if seq % cp:
                raise ValueError(f"seq {seq} does not cut into {cp} chunks")
            q, k, v = make_inputs(seq, batch=batch, heads=heads, kv_heads=kv_heads,
                                  head_dim=head_dim, dtype=dtype, device=device)
            if _of_group(exchange):
                s_l, i = seq // cp, exchange.index
                q, k, v = (t[:, :, i * s_l:(i + 1) * s_l].contiguous() for t in (q, k, v))
            ring_out, ring_ms = time_path(lambda: ring_forward(q, k, v, exchange), steps)
            gather_out, gather_ms = time_path(lambda: gather_forward(q, k, v, exchange),
                                              steps)
            worst = agreement(ring_out, gather_out, exchange)
            if not worst <= AGREE_TOL[dtype]:
                raise AssertionError(
                    f"seq {seq}: the ring's output differs from the gather path's by "
                    f"{worst} of its largest element (limit {AGREE_TOL[dtype]})")
            rows.append(bench_row(seq, cp, batch=batch, heads=heads, head_dim=head_dim,
                                  ring_ms=ring_ms, gather_ms=gather_ms,
                                  platform=device.type, dtype=dtype,
                                  ranks=cp if _of_group(exchange) else 1))
            del q, k, v, ring_out, gather_out
    return rows


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m polyaxon_tpu_torch.scripts.ring_bench")
    p.add_argument("--seq", default="8192,16384",
                   help="comma-separated sequence lengths")
    p.add_argument("--cp", type=int, default=None,
                   help="ring positions (8 alone; the world size under a process group)")
    p.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    return p


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    require_platform(args.platform)
    try:
        rows = run_ring_bench([int(s) for s in args.seq.split(",")], args.cp,
                              platform=args.platform)
    except ValueError as e:
        raise SystemExit(str(e))
    from .. import parallel

    if parallel.process_info_from_env().is_coordinator:
        for row in rows:
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
