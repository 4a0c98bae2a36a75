#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``polyaxon_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its numbers on lines of its own; any failure exits
non-zero:

1. device — the card's name and power limit (nvidia-smi); CUDA required.
2. build  — nvcc builds the paged-decode kernel library from
   ``polyaxon_tpu_torch/csrc`` (seconds, and ptxas's register report).
3. kernel — the CUDA kernel against its plain PyTorch version on the same
   inputs at the llama-1b serving shape (B=8, KVH=4, G=8, D=64, bs=128,
   T=16, ragged lengths incl. 0/1/127/128/129/2048, one table aliasing
   another row's leading blocks), and again at D=128, each in bf16 and
   f32: max abs error and its tolerance, the kernel's time, the plain
   version's time, one PyTorch call's time (scaled_dot_product_attention
   over the gathered cache, a yardstick the port never calls) and the
   bound (live K/V bytes over 3.35 TB/s). Two planted faults (the long
   row's last tile skipped, one of its blocks read off by one) must fail
   the same check, which shows the tolerance can see them.
4. main path — the port's ``build_engine`` at llama-1b full width (22
   layers, hidden 2048, bf16, random init from seed 0) with the
   examples/llama1b_service.yaml runtime settings and attn_impl flash,
   served by the port's HTTP server on an ephemeral port: 8 concurrent
   greedy /generate requests (prompts of 100..1000 tokens, 64 new tokens
   each, two sharing a 256-token prefix). The kernel's launch count over
   that run must equal decode steps x 22. Then one decode_step with
   impl flash against impl gather on the same pools, and the time of a
   decode step on each path.
5. the ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

Needs one card and the repository checkout around this file; imports
nothing of JAX.
"""

from __future__ import annotations

import functools
import importlib
import json
import math
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

KERNEL_SHAPE = dict(batch=8, kv_heads=4, groups=8, block_size=128, max_blocks=16)
KERNEL_LENGTHS = (0, 1, 127, 128, 129, 2048, 700, 1000)
LONG_ROW = 5                                   # the 2048-token row
ALIAS_ROW, ALIAS_SRC, ALIAS_BLOCKS = 7, 5, 4   # row 7 reads row 5's first 4 blocks
# kernel vs plain version, held elementwise to |out - ref| <= atol + rtol|ref|.
# Both compute in f32. In f32 only the order of the sums differs (~1e-6
# relative). In bf16 the two split the softmax differently (each warp's
# 32-token tiles vs 128-token blocks in order), so p is rounded to bf16
# against another running max (<= 2^-9 relative per term, an absolute
# ~1e-3 at most on the output for unit-normal K/V), and the output rounds
# to bf16 (one place is <= 2^-7 relative): atol 3e-3 and rtol 2^-6 hold
# both with a factor of two.
KERNEL_TOL = {"bfloat16": (3e-3, 2.0 ** -6), "float32": (1e-5, 1e-5)}
# flash vs gather logits at llama-1b in bf16: flash rounds p to bf16 before
# p.V (as the TPU kernel does) and gather does not, and the difference
# travels 22 layers of bf16 activations. Logits reach about ±4, where
# bf16's last place is 1/64; 0.125 (8 such places) holds that drift while
# a wrong kernel (a lost mask, a wrong block) moves logits by O(1).
LOGIT_TOL = 0.125

SERVE_SPEC = {
    # examples/llama1b_service.yaml runtime, random init, on the card
    "model": "llama-1b", "init_seed": 0, "max_slots": 8, "block_size": 128,
    "max_seq_len": 2048, "prefill_chunk": 256, "attn_impl": "flash",
    "platform": "cuda", "warmup": True,
}
PROMPT_LENGTHS = (100, 230, 400, 556, 700, 850, 930, 1000)
SHARED_PREFIX = 256          # tokens (two full 128-token blocks)
SHARED_ROWS = (2, 3)         # request 3 goes out after request 2's first token
MAX_NEW = 64


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


# -- phase 1 -----------------------------------------------------------------


def device_phase() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return smi.stdout.strip().splitlines()[0]


# -- phase 3 helpers ----------------------------------------------------------


def kernel_inputs(torch, head_dim: int, dtype, seed: int = 0):
    """q, pools, tables and lengths at the serving shape, made from a seed
    on the card. Rows own disjoint blocks except ALIAS_ROW, whose leading
    ALIAS_BLOCKS entries are ALIAS_SRC's."""
    s = KERNEL_SHAPE
    b, kvh, g, bs, t = (s["batch"], s["kv_heads"], s["groups"],
                        s["block_size"], s["max_blocks"])
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = b * t + 1
    q = torch.randn(b, kvh, g, head_dim, generator=gen, device="cuda").to(dtype)
    k = torch.randn(n, bs, kvh, head_dim, generator=gen, device="cuda").to(dtype)
    v = torch.randn(n, bs, kvh, head_dim, generator=gen, device="cuda").to(dtype)
    perm = torch.randperm(n - 1, generator=gen, device="cuda")
    tables = perm[:b * t].reshape(b, t).to(torch.int32)
    tables[ALIAS_ROW, :ALIAS_BLOCKS] = tables[ALIAS_SRC, :ALIAS_BLOCKS]
    lengths = torch.tensor(KERNEL_LENGTHS, dtype=torch.int32, device="cuda")
    return q, k, v, tables.contiguous(), lengths


def live_kv_bytes(tables, lengths, block_size: int, row_bytes: int) -> int:
    """Bytes of the distinct K and V rows the lengths reach (an aliased
    block counts once)."""
    rows = set()
    for tbl, n in zip(tables.tolist(), lengths.tolist()):
        for p in range(n):
            rows.add((tbl[p // block_size], p % block_size))
    return 2 * len(rows) * row_bytes


def bound_ms(q, tables, lengths, head_dim: int, dtype_name: str) -> tuple[float, str]:
    s = KERNEL_SHAPE
    esize = q.element_size()
    kv = live_kv_bytes(tables, lengths, s["block_size"],
                       s["kv_heads"] * head_dim * esize)
    io = 2 * q.numel() * esize + 4 * (tables.numel() + lengths.numel())
    tokens = int(lengths.clamp(max=s["max_blocks"] * s["block_size"]).sum())
    flops = 4.0 * tokens * s["kv_heads"] * s["groups"] * head_dim
    t_bytes = (kv + io) / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, args_list, iters: int) -> float:
    """Mean device time of ``fn(*args)`` over ``iters`` launches, cycling
    through ``args_list`` (copies that together exceed the 50 MB L2, so
    every launch reads cold memory as a decode step does), after a warm-up
    pass over every copy."""
    for args in args_list:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def worst_ratio(out, ref, tol) -> float:
    """max of |out - ref| / (atol + rtol |ref|): the check passes at <= 1."""
    atol, rtol = tol
    out, ref = out.float(), ref.float()
    return ((out - ref).abs() / (atol + rtol * ref.abs())).max().item()


def planted_faults(pa, q, k, v, tables, lengths, ref, scale, tol) -> dict:
    """The kernel run on inputs that model two faults of the long row's
    walk, held against the true plain output by the same check: each must
    fail it (ratio > 1), or the check could not see such a fault."""
    skipped = lengths.clone()
    skipped[LONG_ROW] -= 32                       # its last 32-token tile
    shifted = tables.clone()
    shifted[LONG_ROW, 7] = tables[LONG_ROW, 8]    # block 7 read as block 8
    ratios = {
        "skipped_last_tile": worst_ratio(
            pa.paged_decode_cuda(q, k, v, tables, skipped, sm_scale=scale), ref, tol),
        "block_off_by_one": worst_ratio(
            pa.paged_decode_cuda(q, k, v, shifted, lengths, sm_scale=scale), ref, tol),
    }
    for fault, ratio in ratios.items():
        if not ratio > 1.0:
            raise AssertionError(f"planted fault {fault} passes the kernel check "
                                 f"(ratio {ratio}); the tolerance cannot see it")
    return ratios


def kernel_phase(torch, pa) -> list[dict]:
    import torch.nn.functional as F

    results = []
    s = KERNEL_SHAPE
    for head_dim in (64, 128):
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[1]
            q, k, v, tables, lengths = kernel_inputs(torch, head_dim, dtype)
            scale = head_dim ** -0.5
            before = pa.launch_counts["paged_decode"]
            out = pa.paged_decode_cuda(q, k, v, tables, lengths, sm_scale=scale)
            torch.cuda.synchronize()
            if pa.launch_counts["paged_decode"] != before + 1:
                raise AssertionError("the kernel wrapper did not count its launch")
            ref = pa.paged_decode_plain(q, k, v, tables, lengths, sm_scale=scale)
            if not torch.isfinite(out.float()).all():
                raise AssertionError(f"non-finite kernel output at D={head_dim} {name}")
            if out[0].abs().max().item() != 0.0:
                raise AssertionError("a length-0 row must come back as zeros")
            err = (out.float() - ref.float()).abs().max().item()
            tol = KERNEL_TOL[name]
            ratio = worst_ratio(out, ref, tol)
            if not ratio <= 1.0:
                raise AssertionError(
                    f"kernel vs plain at D={head_dim} {name}: max abs err "
                    f"{err}, {ratio} times the tolerance {tol}")
            faults = planted_faults(pa, q, k, v, tables, lengths, ref, scale, tol)

            # cold-L2 timing over copies of the pools (and gathered caches)
            pair_bytes = 2 * k.numel() * k.element_size()
            copies = max(2, math.ceil(200e6 / pair_bytes))
            pools = [(q, k.clone(), v.clone(), tables, lengths) for _ in range(copies)]
            t = s["max_blocks"] * s["block_size"]
            mask = (torch.arange(t, device="cuda")[None, :]
                    < lengths[:, None].long())[:, None, None, :]
            qh = q.reshape(s["batch"], s["kv_heads"] * s["groups"], 1, head_dim)
            gathered = [(qh, pa.gather_blocks(kk, tables).transpose(1, 2).contiguous(),
                         pa.gather_blocks(vv, tables).transpose(1, 2).contiguous(), mask)
                        for _, kk, vv, _, _ in pools]
            kern = lambda *a: pa.paged_decode_cuda(*a, sm_scale=scale)  # noqa: E731
            plain = lambda *a: pa.paged_decode_plain(*a, sm_scale=scale)  # noqa: E731
            lib = lambda *a: F.scaled_dot_product_attention(  # noqa: E731
                *a[:3], attn_mask=a[3], scale=scale, enable_gqa=True)
            ms = time_ms(torch, kern, pools, 200)
            plain_ms = time_ms(torch, plain, pools, 20)
            library_ms = time_ms(torch, lib, gathered, 200)
            b_ms, b_by = bound_ms(q, tables, lengths, head_dim, name)
            row = {"head_dim": head_dim, "dtype": name, "max_abs_err": err,
                   "atol": tol[0], "rtol": tol[1], "tol_ratio": ratio,
                   "planted_fault_ratios": faults, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, "bound_ms": b_ms,
                   "bound_us": b_ms * 1e3, "bound_by": b_by}
            log("kernel", **row)
            results.append(row)
            del pools, gathered
    return results


# -- phase 4 -------------------------------------------------------------------


def make_prompts(vocab: int, seed: int = 0):
    """PROMPT_LENGTHS token prompts; the SHARED_ROWS pair starts with one
    SHARED_PREFIX-token prefix."""
    import numpy as np

    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, SHARED_PREFIX).tolist()
    prompts = []
    for i, n in enumerate(PROMPT_LENGTHS):
        if i in SHARED_ROWS:
            prompts.append(prefix + rng.integers(0, vocab, n - SHARED_PREFIX).tolist())
        else:
            prompts.append(rng.integers(0, vocab, n).tolist())
    return prompts


def _post(url: str, body: dict, timeout: float = 900.0):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    return urllib.request.urlopen(req, timeout=timeout)


def drive_requests(base: str, prompts: list, max_new: int,
                   shared_rows: tuple = SHARED_ROWS) -> list[dict]:
    """POST every prompt to /generate at once, greedy. The first of
    ``shared_rows`` streams, and the second goes out only after that
    stream's first token (its prompt's blocks are published by then).
    Returns one result body per prompt."""
    results: list = [None] * len(prompts)
    errors: list = []
    first_token = threading.Event()

    def whole(i):
        if i == shared_rows[1]:
            if not first_token.wait(900):
                raise TimeoutError("the first sharer never produced a token")
        with _post(base + "/generate", {"tokens": prompts[i],
                                        "max_new_tokens": max_new}) as r:
            results[i] = json.loads(r.read())

    def streamed(i):
        toks = []
        with _post(base + "/generate", {"tokens": prompts[i], "stream": True,
                                        "max_new_tokens": max_new}) as r:
            for line in r:
                msg = json.loads(line)
                if "token" in msg:
                    toks.append(msg["token"])
                    first_token.set()
                elif msg.get("done"):
                    if msg["tokens"] != toks:
                        raise AssertionError("stream lines disagree with the final body")
                    results[i] = msg
        first_token.set()

    def run(i):
        try:
            (streamed if i == shared_rows[0] else whole)(i)
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append((i, e))
            first_token.set()

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if errors:
        raise RuntimeError(f"requests failed: {errors}")
    if any(t.is_alive() for t in threads) or any(r is None for r in results):
        raise TimeoutError("requests did not complete")
    return results


def wait_healthy(base: str, timeout: float = 600.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
                if r.status == 200:
                    return
        except urllib.error.HTTPError as e:
            if e.code != 503:
                raise
        except urllib.error.URLError:
            pass
        time.sleep(0.2)
    raise TimeoutError("/healthz never answered 200")


def serve_phase(torch, spec: dict, prompts: list, max_new: int) -> dict:
    """Build the engine, serve it, drive the requests; returns the
    measurements and leaves the engine (stopped) for the next phase."""
    from polyaxon_tpu_torch.serve.runtime import build_engine, warmup
    from polyaxon_tpu_torch.serve.server import build_server

    pa = importlib.import_module("polyaxon_tpu_torch.ops.paged_attention")
    t0 = time.monotonic()
    engine = build_engine(spec)
    build_s = time.monotonic() - t0
    engine.start()
    srv = build_server(engine, "127.0.0.1", 0, model_name=engine.model_name)
    http = threading.Thread(target=srv.serve_forever, daemon=True)
    http.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        warm = threading.Thread(target=warmup, args=(engine,), daemon=True)
        warm.start()
        wait_healthy(base)
        warm.join(timeout=600)
        if warm.is_alive():
            raise TimeoutError("warmup request did not finish")

        if engine.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        pa.reset_launch_counts()
        steps0 = engine.decode_steps
        t1 = time.monotonic()
        results = drive_requests(base, prompts, max_new)
        wall_s = time.monotonic() - t1
        launches = pa.launch_counts["paged_decode"]
        steps = engine.decode_steps - steps0
        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
        engine.stop()
    vocab = engine.cfg.vocab_size
    for i, res in enumerate(results):
        toks = res["tokens"]
        if len(toks) != max_new or not all(0 <= t < vocab for t in toks):
            raise AssertionError(f"request {i} returned {len(toks)} tokens: {toks}")
    ttfts = sorted(r["ttft_ms"] for r in results)
    return {
        "engine": engine, "engine_build_s": build_s, "launches": launches,
        "decode_steps": steps, "wall_s": wall_s,
        "tokens_per_s": sum(len(r["tokens"]) for r in results) / wall_s,
        "ttft_p50_ms": ttfts[len(ttfts) // 2],
        "prefix_cache_hits": stats["prefix_cache_hits"],
        "kv_audit_violations": stats["kv_audit_violations"],
        "peak_mem_gib": (torch.cuda.max_memory_allocated() / 2**30
                         if engine.device.type == "cuda" else None),
    }


def compare_phase(torch, engine, lengths=(1, 127, 128, 129, 300, 700, 1000, 1900),
                  timed_steps: int = 20) -> dict:
    """Prefill len(lengths) sequences through the engine's own model code,
    then run one decode_step with impl flash and one with impl gather on
    copies of the same pools; returns the max logit difference and, for
    each impl, the decode step's time (host clock over ``timed_steps``
    steps) and its profile."""
    import numpy as np

    from polyaxon_tpu_torch.serve.kv_cache import SequenceBlocks
    from polyaxon_tpu_torch.serve.model import decode_step, init_cache, prefill_chunk

    cfg, dev, bs = engine.cfg, engine.device, engine.block_size
    t = engine.max_blocks_per_seq
    cache = init_cache(cfg, num_blocks=len(lengths) * t, block_size=bs,
                       enable_prefix_cache=False, device=dev)
    rng = np.random.default_rng(1)
    seqs = []
    for n in lengths:
        seq = SequenceBlocks()
        cache.ensure(seq, n + 1)
        tbl = torch.as_tensor(cache.block_table_array([seq], t), device=dev)
        toks = rng.integers(0, cfg.vocab_size, n)
        for lo in range(0, n, engine.prefill_chunk):
            chunk = toks[lo:lo + engine.prefill_chunk]
            padded = np.zeros((1, engine.prefill_chunk), np.int64)
            padded[0, :len(chunk)] = chunk
            prefill_chunk(engine.params, torch.as_tensor(padded, device=dev), lo,
                          len(chunk), cache.k, cache.v, tbl, cfg=cfg)
        seq.length = n
        seqs.append(seq)
    tables = torch.as_tensor(cache.block_table_array(seqs, t), device=dev)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, len(lengths)), device=dev)
    positions = torch.as_tensor(lengths, device=dev)
    active = torch.ones(len(lengths), dtype=torch.bool, device=dev)

    def step(impl, k, v):
        return decode_step(engine.params, tokens, positions, k, v, tables, active,
                           cfg=cfg, impl=impl)

    flash = step("flash", cache.k.clone(), cache.v.clone())
    gather = step("gather", cache.k.clone(), cache.v.clone())
    if not (torch.isfinite(flash).all() and torch.isfinite(gather).all()):
        raise AssertionError("non-finite decode logits")
    diff = (flash - gather).abs().max().item()
    if not diff <= LOGIT_TOL:
        raise AssertionError(f"flash vs gather logits differ by {diff} > {LOGIT_TOL}")
    out = {"max_logit_diff": diff, "logit_tol": LOGIT_TOL,
           "max_abs_logit": gather.abs().max().item(),
           "batch": len(lengths), "lengths": list(lengths)}
    k, v = cache.k.clone(), cache.v.clone()
    for impl in ("flash", "gather"):
        step(impl, k, v)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(timed_steps):
            logits = step(impl, k, v)
        logits.cpu()
        timed = {"decode_step_ms": (time.perf_counter() - t0) * 1e3 / timed_steps}
        if dev.type == "cuda":
            timed.update(profile_steps(torch, functools.partial(step, impl, k, v)))
        out[impl] = timed
    return out


def profile_steps(torch, fn, steps: int = 3) -> dict:
    """Device time of ``steps`` calls of ``fn`` by kernel, from
    torch.profiler: the per-step device time, the paged-decode kernel's
    share of it, the device's idle share of the wall time, and the five
    largest kernels."""
    from torch.profiler import ProfilerActivity, profile

    def device_us(evt):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if getattr(evt, attr, None) is not None:
                return float(getattr(evt, attr))
        return 0.0

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # kernels only: a CPU op's self device time repeats its kernels' time
    rows = sorted(((e.key, device_us(e), e.count) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and device_us(e) > 0), key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    paged = sum(r[1] for r in rows if "paged_decode_kernel" in r[0])
    return {
        "profiled_steps": steps,
        "device_ms_per_step": total / steps / 1e3,
        "wall_ms_per_step": wall_us / steps / 1e3,
        "device_idle_share": (1.0 - total / wall_us) if total else None,
        "paged_decode_ms_per_step": paged / steps / 1e3,
        "paged_decode_share": paged / total if total else None,
        "top_kernels": [{"name": k[:80], "ms_per_step": t / steps / 1e3,
                         "calls_per_step": c / steps} for k, t, c in rows[:6]],
    }


# -- main --------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        pa = importlib.import_module("polyaxon_tpu_torch.ops.paged_attention")
    except ImportError as e:
        print(f"chip_smoke: the polyaxon_tpu_torch package is missing next "
              f"to this script ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    device_phase()
    kind = torch.cuda.get_device_name(0)
    log("device", kind=kind, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.monotonic()
    path = pa.PAGED_DECODE_LIB.build()
    pa.PAGED_DECODE_LIB.load()
    log("build", seconds=time.monotonic() - t0, library=path.name)
    for line in pa.PAGED_DECODE_LIB.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print("  " + line.strip(), flush=True)

    kernel_rows = kernel_phase(torch, pa)

    from polyaxon_tpu_torch.models import REGISTRY

    vocab = REGISTRY[SERVE_SPEC["model"]][1].vocab_size
    served = serve_phase(torch, SERVE_SPEC, make_prompts(vocab), MAX_NEW)
    engine = served.pop("engine")
    layers = engine.cfg.num_layers
    log("serve", **served, layers=layers)
    if served["decode_steps"] <= 0:
        raise AssertionError("no decode step ran")
    if served["launches"] != served["decode_steps"] * layers:
        raise AssertionError(
            f"paged_decode launched {served['launches']} times over "
            f"{served['decode_steps']} decode steps x {layers} layers")
    if served["prefix_cache_hits"] < 2:
        raise AssertionError(f"prefix_cache_hits {served['prefix_cache_hits']} < 2")
    if served["kv_audit_violations"]:
        raise AssertionError("KV refcount audit violations")

    log("compare", **compare_phase(torch, engine))

    main_row = kernel_rows[0]  # D=64 bf16: the shape the main path gives it
    print(json.dumps({"kernels": [{
        "name": "paged_decode", "route": "cuda",
        "source": "polyaxon_tpu_torch/csrc/paged_decode.cu",
        "replaces": "polyaxon_tpu/ops/paged_attention.py:110",
        "launches": served["launches"],
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
