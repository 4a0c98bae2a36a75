"""Online-inference load generator of the port: the serving engine's
numbers, with the keys of the repository's ``scripts/serve_bench.py``.

- **Engine sweep** (default): for each width C, ``requests`` prompts
  admitted at once against ``max_slots=C``: decode tokens/s, TTFT p50/p95
  and per-request wall time. C=1 is the sequential baseline, so
  ``batched_vs_sequential`` is the iteration-level-batching win.
- **Prefix sharing** (``--prefix-share``): concurrent requests sharing one
  long system prompt, against the same engine with the prefix cache off;
  TTFT both ways and the KV blocks each request allocated beyond the
  shared prefix.
- **Speculative decoding** (``--speculative``): plain decode against
  draft-propose/target-verify, the target being the draft plus zeroed
  residual layers (``target_layers_mult`` x its depth, the same logits),
  so acceptance is ~100% and the speedup is the fewer target steps.

Usage:
    python -m polyaxon_tpu_torch.scripts.serve_bench [--requests N]
        [--max-new M] [--prompt-len P] [--sweep 1,2,4,8] [--prefix-share]
        [--speculative] [--model NAME] [--attn-impl flash|gather]
        [--platform cuda|cpu] [--out PATH]

The weights are the port's random init at ``seed`` on the platform's
device; decode attention is the paged CUDA kernel (``--attn-impl flash``,
the default) or gathered math. ``--orchestrated`` is not ported: it
drives a ``kind: service`` run through the control plane, which the port
does not import.

Importable: ``run_engine_bench`` / ``run_sweep`` / ``run_prefix_share_bench``
/ ``run_speculative_bench`` return the same dicts as the JAX tool's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Optional

from ..bench import require_platform

DEFAULT_MODEL = "llama-tiny"


def _quant(vals, q):
    if not vals:
        return None
    vs = sorted(vals)
    return vs[min(int(round(q * (len(vs) - 1))), len(vs) - 1)]


def _model(model: str, seed: int, platform: str, params=None, cfg=None) -> tuple:
    """(params, cfg): the given ones, else the registry's config and the
    port's init at ``seed`` on the platform's device."""
    from ..models import REGISTRY, transformer
    from ..serve.runtime import resolve_device

    if cfg is None:
        cfg = REGISTRY[model][1]
    if params is None:
        params = transformer.init(cfg, seed=seed, device=resolve_device({"platform": platform}))
    return params, cfg


def _drive(engine, reqs) -> None:
    while not all(r.state in ("done", "failed") for r in reqs):
        engine.step()


def run_engine_bench(concurrency: int, *, requests: int = 16,
                     prompt_len: int = 24, max_new: int = 32,
                     block_size: int = 16, seed: int = 0,
                     params=None, cfg=None, warmup: int = 2,
                     model: str = DEFAULT_MODEL, platform: str = "cuda",
                     attn_impl: str = "flash") -> dict:
    """One sweep point: ``requests`` prompts against a width-
    ``concurrency`` engine. Decode throughput excludes the warmup
    requests (the kernels' first launches) but includes queueing."""
    import numpy as np

    from ..serve.engine import SamplingParams, ServeEngine

    params, cfg = _model(model, seed, platform, params, cfg)
    rng = np.random.default_rng(seed)
    max_seq = prompt_len + max_new + 8
    engine = ServeEngine(params, cfg, max_slots=concurrency, block_size=block_size,
                         prefill_chunk=min(prompt_len, 32), max_seq_len=max_seq,
                         attn_impl=attn_impl)
    sp = SamplingParams(max_new_tokens=max_new)

    _drive(engine, [engine.submit(
        [int(t) for t in rng.integers(1, cfg.vocab_size, prompt_len)], sp)
        for _ in range(min(warmup, concurrency) or 1)])

    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, prompt_len)]
               for _ in range(requests)]
    t0 = time.perf_counter()
    reqs = [engine.submit(p, sp) for p in prompts]
    _drive(engine, reqs)
    wall = time.perf_counter() - t0
    assert all(r.state == "done" for r in reqs)
    total_tokens = sum(len(r.out_tokens) for r in reqs)
    ttfts = [r.ttft_s for r in reqs if r.ttft_s is not None]
    per_req_wall = [r.finished_at - r.created_at for r in reqs]
    return {
        "concurrency": concurrency,
        "requests": requests,
        "prompt_len": prompt_len,
        "max_new": max_new,
        "wall_s": round(wall, 4),
        "tokens": total_tokens,
        "tokens_per_sec": round(total_tokens / wall, 2),
        "ttft_p50_ms": round(_quant(ttfts, 0.5) * 1e3, 2),
        "ttft_p95_ms": round(_quant(ttfts, 0.95) * 1e3, 2),
        "req_wall_p50_s": round(_quant(per_req_wall, 0.5), 4),
    }


def run_sweep(widths=(1, 2, 4, 8), *, model: str = DEFAULT_MODEL, platform: str = "cuda",
              attn_impl: str = "flash", **kw) -> dict:
    """The sweep over one set of weights; adds the batched-vs-sequential
    ratio (the widest point over the width-1 baseline)."""
    params, cfg = _model(model, kw.get("seed", 0), platform)
    rows = [run_engine_bench(c, params=params, cfg=cfg, attn_impl=attn_impl, **kw)
            for c in widths]
    base = rows[0]["tokens_per_sec"]
    widest = rows[-1]["tokens_per_sec"]
    return {
        "kind": "serve_bench",
        "model": model,
        "platform": platform,
        "rows": rows,
        "batched_vs_sequential": round(widest / base, 2) if base else None,
    }


def run_prefix_share_bench(*, requests: int = 64, sys_len: int = 1024,
                           tail_len: int = 8, max_new: int = 8,
                           block_size: int = 16, prefill_chunk: int = 32,
                           seed: int = 0, best_of: int = 3,
                           params=None, cfg=None, model: str = DEFAULT_MODEL,
                           platform: str = "cuda", attn_impl: str = "flash") -> dict:
    """Shared-system-prompt fleet: ``requests`` concurrent prompts that
    all start with the same ``sys_len``-token system prompt (distinct
    ``tail_len`` tails), prefix cache warmed against disabled; TTFT both
    ways and the extra KV blocks each sharing request allocated.
    ``best_of`` repeats each side on a fresh engine and keeps the repeat
    of least TTFT p50."""
    import numpy as np

    from ..serve.engine import SamplingParams, ServeEngine

    params, cfg = _model(model, seed, platform, params, cfg)
    rng = np.random.default_rng(seed)
    sys_prompt = [int(t) for t in rng.integers(1, cfg.vocab_size, sys_len)]
    prompts = [sys_prompt + [int(t) for t in rng.integers(1, cfg.vocab_size, tail_len)]
               for _ in range(requests)]
    max_seq = sys_len + tail_len + max_new + block_size
    sp = SamplingParams(max_new_tokens=max_new)

    def _measure(enable_prefix_cache: bool) -> dict:
        best = None
        for _ in range(max(best_of, 1)):
            eng = ServeEngine(params, cfg, max_slots=requests, block_size=block_size,
                              prefill_chunk=prefill_chunk, max_seq_len=max_seq,
                              enable_prefix_cache=enable_prefix_cache, attn_impl=attn_impl)
            # the warm request runs the shapes once AND (shared side)
            # publishes the system prompt's blocks into the prefix index
            _drive(eng, [eng.submit(sys_prompt, sp)])
            s0 = eng.snapshot()
            t0 = time.perf_counter()
            reqs = [eng.submit(p, sp) for p in prompts]
            _drive(eng, reqs)
            wall = time.perf_counter() - t0
            assert all(r.state == "done" for r in reqs)
            s1 = eng.snapshot()
            ttfts = [r.ttft_s for r in reqs if r.ttft_s is not None]
            hits = s1["prefix_cache_hits"] - s0["prefix_cache_hits"]
            misses = s1["prefix_cache_misses"] - s0["prefix_cache_misses"]
            row = {
                "ttft_p50_ms": round(_quant(ttfts, 0.5) * 1e3, 2),
                "ttft_p95_ms": round(_quant(ttfts, 0.95) * 1e3, 2),
                "wall_s": round(wall, 3),
                "prefix_hits": hits,
                "prefix_misses": misses,
                # prompt blocks each request allocated (and prefilled)
                # itself; a fully-shared prefix block costs zero
                "extra_kv_blocks_per_request": round(misses / requests, 3),
                "cow_copies": s1["cow_copies"] - s0["cow_copies"],
                "kv_audit_violations": s1["kv_audit_violations"],
            }
            if best is None or row["ttft_p50_ms"] < best["ttft_p50_ms"]:
                best = row
        return best

    shared = _measure(True)
    baseline = _measure(False)
    return {
        "kind": "prefix_share_bench",
        "requests": requests,
        "sys_len": sys_len,
        "tail_len": tail_len,
        "max_new": max_new,
        "block_size": block_size,
        "shared_prefix_blocks": sys_len // block_size,
        "shared": shared,
        "reprefill": baseline,
        "ttft_p50_speedup": round(
            baseline["ttft_p50_ms"] / max(shared["ttft_p50_ms"], 1e-9), 2),
        "ttft_p95_speedup": round(
            baseline["ttft_p95_ms"] / max(shared["ttft_p95_ms"], 1e-9), 2),
    }


def run_speculative_bench(*, requests: int = 4, prompt_len: int = 32,
                          max_new: int = 96, spec_k: int = 6,
                          target_layers_mult: int = 32,
                          block_size: int = 16, seed: int = 0,
                          best_of: int = 3, model: str = DEFAULT_MODEL,
                          platform: str = "cuda", attn_impl: str = "flash") -> dict:
    """Plain decode against speculative decode on an identity-extended
    target: the draft is ``model`` and the target the draft plus zeroed
    residual layers (the same logits at ``target_layers_mult`` x the
    per-token layer cost), so the speedup measures exactly what
    speculation buys: one target step per accepted window instead of one
    per token."""
    import numpy as np

    from ..serve.engine import SamplingParams, ServeEngine
    from ..serve.model import extend_with_identity_layers

    params, cfg = _model(model, seed, platform)
    big_params, big_cfg = extend_with_identity_layers(
        params, cfg, cfg.num_layers * (target_layers_mult - 1))
    rng = np.random.default_rng(seed)
    max_seq = prompt_len + max_new + spec_k + block_size
    sp = SamplingParams(max_new_tokens=max_new)

    def _measure(**spec_kw: Any) -> tuple:
        eng = ServeEngine(big_params, big_cfg, max_slots=requests, block_size=block_size,
                          prefill_chunk=min(prompt_len, 32), max_seq_len=max_seq,
                          attn_impl=attn_impl, **spec_kw)
        _drive(eng, [eng.submit(
            [int(t) for t in rng.integers(1, cfg.vocab_size, prompt_len)], sp)
            for _ in range(2)])
        best = 0.0
        for _ in range(max(best_of, 1)):
            prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, prompt_len)]
                       for _ in range(requests)]
            t0 = time.perf_counter()
            reqs = [eng.submit(p, sp) for p in prompts]
            _drive(eng, reqs)
            wall = time.perf_counter() - t0
            assert all(r.state == "done" for r in reqs)
            tokens = sum(len(r.out_tokens) for r in reqs)
            best = max(best, tokens / wall)
        return best, eng.snapshot()

    plain_tps, _ = _measure()
    spec_tps, snap = _measure(draft_params=params, draft_cfg=cfg, spec_k=spec_k)
    proposed = snap["spec_tokens_proposed"]
    accepted = snap["spec_tokens_accepted"]
    return {
        "kind": "speculative_bench",
        "requests": requests,
        "prompt_len": prompt_len,
        "max_new": max_new,
        "spec_k": spec_k,
        "target_layers": big_cfg.num_layers,
        "draft_layers": cfg.num_layers,
        "plain_tokens_per_sec": round(plain_tps, 2),
        "spec_tokens_per_sec": round(spec_tps, 2),
        "speedup": round(spec_tps / max(plain_tps, 1e-9), 2),
        "tokens_proposed": proposed,
        "tokens_accepted": accepted,
        "acceptance_rate": round(accepted / max(proposed, 1), 4),
        "kv_audit_violations": snap["kv_audit_violations"],
    }


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m polyaxon_tpu_torch.scripts.serve_bench")
    p.add_argument("--requests", type=int, default=16)
    p.add_argument("--max-new", type=int, default=32)
    p.add_argument("--prompt-len", type=int, default=24)
    p.add_argument("--sweep", default="1,2,4,8")
    p.add_argument("--prefix-share", action="store_true",
                   help="shared-system-prompt fleet vs re-prefill baseline")
    p.add_argument("--speculative", action="store_true",
                   help="speculative decoding vs plain decode")
    p.add_argument("--spec-k", type=int, default=6)
    p.add_argument("--sys-len", type=int, default=1024)
    p.add_argument("--share-requests", type=int, default=64)
    p.add_argument("--model", "-m", default=DEFAULT_MODEL,
                   help="model zoo name (causal LM families only)")
    p.add_argument("--attn-impl", choices=("gather", "flash"), default="flash",
                   help="decode attention: the paged CUDA kernel, or gathered math")
    p.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--orchestrated", action="store_true",
                   help="not ported (a service run through the control plane)")
    p.add_argument("--out", default=None)
    return p


def main(argv: Optional[list] = None) -> int:
    args = _parser().parse_args(argv)
    if args.orchestrated:
        print("--orchestrated is not ported: it drives a service run through the control "
              "plane's store and agent, which the port does not import", file=sys.stderr)
        return 2
    require_platform(args.platform)
    where = {"model": args.model, "platform": args.platform, "attn_impl": args.attn_impl}
    widths = tuple(int(w) for w in args.sweep.split(","))
    out = run_sweep(widths, requests=args.requests, prompt_len=args.prompt_len,
                    max_new=args.max_new, **where)
    if args.prefix_share:
        out["prefix_share"] = run_prefix_share_bench(
            requests=args.share_requests, sys_len=args.sys_len, **where)
    if args.speculative:
        # its own max_new: the measurement window must amortize the warmup,
        # whatever the sweep's per-request token count
        out["speculative"] = run_speculative_bench(spec_k=args.spec_k, **where)
    out["host"] = {"cpus": os.cpu_count()}
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
