"""Serving entrypoint of the port — twin of ``polyaxon_tpu/serve/runtime.py``.

    PLX_SERVE_SPEC='{"model": "llama-tiny", "platform": "cpu", "port": 0,
                     "speculative": {"draft": "llama-tiny", "k": 4}}' \\
        python -m polyaxon_tpu_torch.serve.runtime

Spec keys (the JAX runtime's, as far as this port goes):
    model: registry name (default "llama-tiny")
    checkpoint: checkpoint dir (a training run's outputs/checkpoints) or
        {path, step}; restored READ-ONLY through the sha256 manifests (N
        replicas restoring the same directory have no side effects).
    import: foreign-checkpoint boot: a path, or {path, layout:
        flat|hf-llama|auto, dtype?, key_map?, transpose?}, read through
        ``partition.convert``. A native ``checkpoint:`` wins. Both absent:
        random init from ``init_seed`` (default 0).
    speculative: {draft, k} — draft-verify speculative decoding: ``draft``
        is a zoo name (it must share the target's vocabulary) or a sub-spec
        dict with its own checkpoint/import keys, ``k`` the tokens proposed
        per iteration (1..16). Greedy outputs are token-for-token those of
        plain decode.
    max_seq_len, block_size, num_blocks, max_slots, prefill_chunk,
    attn_impl ("gather" | "flash"), port (default 8000), bind,
    max_waiting, preempt_grace_s, prefix_cache (default true),
    drain_timeout_s (SIGTERM graceful window, default 30),
    warmup (generate a tiny request at startup so /healthz flips ready
    only once the model really generates, default true)
    platform: "cuda" (default) or "cpu". With "cuda" and no usable CUDA
    device, :func:`build_engine` raises; only an explicit "cpu" runs on
    the CPU.

Not ported yet (each raises ``SystemExit`` naming its ROADMAP item): the
control-plane bridge of the JAX runtime — ``report_interval`` (heartbeat
reporter and run outputs), ``watchdog`` (the decode-iteration watchdog),
``chaos`` (fault injection) and the drain markers — and
``num_cpu_devices``.
"""

from __future__ import annotations

import json
import signal
import threading
from typing import Any

import torch

DEFAULT_SERVE_PORT = 8000

#: keys of the JAX runtime the port does not take yet -> ROADMAP item
_NOT_PORTED = {
    "report_interval": "A7 (the control-plane bridge: ServeReporter)",
    "watchdog": "A7 (the control-plane bridge: the step watchdog)",
    "chaos": "A7 (the control-plane bridge: ServeChaos)",
    "num_cpu_devices": "A6 (device meshes)",
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
    """Weights for the engine on ``device``: a read-only checkpoint restore
    when the spec names one (torn newest steps fall back through the
    manifest walk), a FOREIGN checkpoint through ``import:`` (read-only by
    construction), random init otherwise. A native ``checkpoint:`` wins
    over ``import:``, as the trainer's resume beats its re-import. Returns
    (params, provenance dict)."""
    ckpt = spec.get("checkpoint")
    if ckpt:
        from ..train.checkpoint import CheckpointConfig, Checkpointer, to_device

        path = ckpt if isinstance(ckpt, str) else ckpt.get("path")
        step = None if isinstance(ckpt, str) else ckpt.get("step")
        ro = Checkpointer(CheckpointConfig(directory=path), read_only=True)
        raw, restored_step = ro.restore_raw(
            step=int(step) if step is not None else None)
        return to_device(raw["params"], device), {
            "restored_from": path, "restored_step": int(restored_step)}
    imp = spec.get("import")
    if imp:
        from ..partition import convert as pconvert

        if isinstance(imp, str):
            imp = {"path": imp}
        params = pconvert.import_params(
            imp["path"], cfg, device=device,
            layout=imp.get("layout", "auto"),
            dtype=imp.get("dtype"),
            key_map=imp.get("key_map"),
            transpose=imp.get("transpose"),
        )
        return params, {"imported_from": imp["path"],
                        "import_layout": imp.get("layout", "auto"),
                        "restored_step": -1}
    from ..models import transformer

    seed = int(spec.get("init_seed", 0))
    return transformer.init(cfg, seed=seed, device=device), {
        "restored_step": -1, "init_seed": seed}


def load_draft(spec: dict, target_cfg, device):
    """Speculative draft weights: ``speculative.draft`` is a zoo name
    (random init unless the draft dict carries its own checkpoint/import
    keys) or a full sub-spec dict. The draft must speak the target's
    vocabulary. Returns (draft_params, draft_cfg, k), or (None, None, 0)
    when speculative decoding is off."""
    sd = spec.get("speculative")
    if not sd:
        return None, None, 0
    from ..models import REGISTRY

    if not isinstance(sd, dict) or "draft" not in sd:
        raise SystemExit("speculative: needs {draft, k}")
    draft = sd["draft"]
    dspec = {"model": draft} if isinstance(draft, str) else dict(draft)
    dname = dspec.get("model", "llama-tiny")
    if dname not in REGISTRY:
        raise SystemExit(
            f"speculative.draft model {dname!r} unknown; "
            f"available: {sorted(REGISTRY)}")
    dfamily, dcfg = REGISTRY[dname]
    if dfamily != "lm":
        raise SystemExit(
            f"speculative.draft needs a causal-LM model; "
            f"{dname!r} is {dfamily!r}")
    if dcfg.vocab_size != target_cfg.vocab_size:
        raise SystemExit(
            f"speculative.draft vocab {dcfg.vocab_size} != target vocab "
            f"{target_cfg.vocab_size}")
    k = int(sd.get("k", 4))
    if not 1 <= k <= 16:
        raise SystemExit(f"speculative.k must be 1..16, got {k}")
    dparams, _ = load_params(dspec, dcfg, device)
    return dparams, dcfg, k


def build_engine(spec: dict):
    """REGISTRY model + overrides -> a ready (not yet started) engine."""
    from dataclasses import replace

    from ..models import REGISTRY
    from .engine import ServeEngine

    for key, item in _NOT_PORTED.items():
        if spec.get(key):
            raise SystemExit(f"{key}: not ported to polyaxon_tpu_torch yet "
                             f"(ROADMAP {item})")
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
    draft_params, draft_cfg, spec_k = load_draft(spec, cfg, device)
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
        draft_params=draft_params,
        draft_cfg=draft_cfg,
        spec_k=spec_k,
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


def main() -> None:
    """The pod entry of a ``kind: service`` runtime: the spec as JSON in
    ``PLX_SERVE_SPEC``."""
    import os

    raw = os.environ.get("PLX_SERVE_SPEC")
    if not raw:
        raise SystemExit("PLX_SERVE_SPEC not set")
    run_serve(json.loads(raw))


if __name__ == "__main__":
    main()
