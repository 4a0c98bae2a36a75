"""Serving entrypoint of the port — twin of ``polyaxon_tpu/serve/runtime.py``.

Spec keys (the JAX runtime's, as far as this port goes):
    model: registry name (default "llama-tiny")
    init_seed: seed of the random init (default 0)
    max_seq_len, block_size, num_blocks, max_slots, prefill_chunk,
    attn_impl ("gather" | "flash"), port (default 8000), bind,
    max_waiting, preempt_grace_s, prefix_cache (default true),
    drain_timeout_s (SIGTERM graceful window, default 30),
    warmup (generate a tiny request at startup so /healthz flips ready
    only once the model really generates, default true)
    platform: "cuda" (default) or "cpu". With "cuda" and no usable CUDA
    device, :func:`build_engine` raises; only an explicit "cpu" runs on
    the CPU.

Not ported yet (each raises ``SystemExit``): ``checkpoint:`` and
``import:`` restore, and ``speculative:`` decoding. The control-plane
bridge of the JAX runtime (heartbeat reporter, drain markers, chaos hooks,
step watchdog) is not part of the port either.
"""

from __future__ import annotations

import json
import signal
import threading
from typing import Any

import torch

DEFAULT_SERVE_PORT = 8000

_NOT_PORTED = {
    "checkpoint": "checkpoint restore",
    "import": "foreign-checkpoint import",
    "speculative": "speculative decoding",
}


def resolve_device(spec: dict) -> torch.device:
    """The engine's device from the ``platform`` key: CUDA by default,
    the CPU only when asked for."""
    platform = spec.get("platform") or "cuda"
    if platform == "cpu":
        return torch.device("cpu")
    if platform == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "platform 'cuda' needs a usable CUDA device and none is "
                "available; pass platform: cpu to serve on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    raise ValueError(f"unknown platform {platform!r}; valid: cuda|cpu")


def load_params(spec: dict, cfg, device) -> tuple[dict, dict]:
    """Random init from ``init_seed`` on ``device``. Returns (params,
    provenance dict)."""
    from ..models import transformer

    seed = int(spec.get("init_seed", 0))
    return transformer.init(cfg, seed=seed, device=device), {
        "restored_step": -1, "init_seed": seed}


def build_engine(spec: dict):
    """REGISTRY model + overrides -> a ready (not yet started) engine."""
    from dataclasses import replace

    from ..models import REGISTRY
    from .engine import ServeEngine

    for key, what in _NOT_PORTED.items():
        if spec.get(key):
            raise SystemExit(f"{key}: {what} is not ported to "
                             f"polyaxon_tpu_torch yet")
    name = spec.get("model", "llama-tiny")
    if name not in REGISTRY:
        raise SystemExit(
            f"Unknown model {name!r}; available: {sorted(REGISTRY)}")
    family, cfg = REGISTRY[name]
    if family != "lm":
        raise SystemExit(f"serve runtime needs a causal-LM model; "
                         f"{name!r} is {family!r}")
    device = resolve_device(spec)
    max_seq = int(spec.get("max_seq_len", min(cfg.max_seq, 2048)))
    if max_seq > cfg.max_seq:
        cfg = replace(cfg, max_seq=max_seq)
    params, provenance = load_params(spec, cfg, device)
    engine = ServeEngine(
        params, cfg,
        max_slots=int(spec.get("max_slots", 8)),
        block_size=int(spec.get("block_size", 16)),
        num_blocks=(int(spec["num_blocks"])
                    if spec.get("num_blocks") is not None else None),
        prefill_chunk=int(spec.get("prefill_chunk", 64)),
        max_seq_len=max_seq,
        attn_impl=spec.get("attn_impl", "gather"),
        max_waiting=int(spec.get("max_waiting", 128)),
        preempt_grace_s=float(spec.get("preempt_grace_s", 2.0)),
        enable_prefix_cache=bool(spec.get("prefix_cache", True)),
    )
    engine.provenance = provenance
    engine.model_name = name
    return engine


def warmup(engine) -> None:
    """Generate a tiny request so the engine proves it runs the model
    (the /healthz readiness gate flips on its first prefill)."""
    from .engine import SamplingParams

    engine.generate([1, 2, 3], SamplingParams(max_new_tokens=2),
                    timeout=600.0)


def run_serve(spec: dict[str, Any]) -> None:
    """Build the engine, serve HTTP until SIGTERM/SIGINT, then drain:
    admission closes (/healthz 503), in-flight requests finish within
    ``drain_timeout_s``, and the server stops. A second signal stops
    immediately."""
    from .server import build_server

    engine = build_engine(spec)
    engine.start()
    if spec.get("warmup", True):
        def _warmup() -> None:
            try:
                warmup(engine)
            except Exception as e:  # noqa: BLE001 — visible, non-fatal
                print(f"[serve] warmup failed: {e!r}", flush=True)

        threading.Thread(target=_warmup, daemon=True,
                         name="serve-warmup").start()

    bind = spec.get("bind", "127.0.0.1")
    port = int(spec.get("port", DEFAULT_SERVE_PORT))
    try:
        srv = build_server(engine, bind, port, model_name=engine.model_name)
    except OSError:
        # the declared port is taken: serve on an ephemeral one and say so
        srv = build_server(engine, bind, 0, model_name=engine.model_name)
    actual_port = srv.server_address[1]

    stop_event = threading.Event()
    drain_timeout = float(spec.get("drain_timeout_s", 30.0))

    def _graceful(_sig, _frm):
        if drain_timeout <= 0 or engine.draining or stop_event.is_set():
            stop_event.set()
            return
        engine.begin_drain()

        def _await_drain():
            engine.await_drain(timeout=drain_timeout)
            stop_event.set()

        threading.Thread(target=_await_drain, daemon=True,
                         name="serve-drain").start()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)

    server_thread = threading.Thread(target=srv.serve_forever, daemon=True,
                                     name="serve-http")
    server_thread.start()
    print(json.dumps({"serving": {"model": engine.model_name,
                                  "port": actual_port,
                                  "device": str(engine.device),
                                  "attn_impl": engine.attn_impl,
                                  **engine.provenance}}),
          flush=True)
    while not stop_event.wait(0.2):
        pass
    srv.shutdown()
    srv.server_close()
    engine.stop()
