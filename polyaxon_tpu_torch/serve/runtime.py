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
    report_interval: seconds between the replica's heartbeats (default 2)
        when the control plane launched it (``PLX_RUN_UUID``): each beat
        carries the engine's ``serve`` snapshot, its drained TTFT and
        inter-token samples and ``SeriesBuffer`` points; replica 0 also
        writes the ``serve_*`` run outputs. The reporter honours drain
        markers (``serve-drain-<replica>.json`` in the run directory): a
        marker closes admission, its removal (or its ``expires_at``)
        reopens it — only for drains the marker started.
    watchdog: the decode-iteration watchdog, on by default (false
        disables; {stall_factor (10), min_s (60), compile_grace_s (600)}
        tunes): iteration silence past max(min_s, stall_factor x p95)
        dumps stacks, sends a ``ServingStalled`` status and hard-exits.
    chaos: {hang_after_requests, replica (0), hang_sleep_s} — wedge one
        replica's decode loop once (budget kept in the run directory).
    platform: "cuda" (default) or "cpu". With "cuda" and no usable CUDA
    device, :func:`build_engine` raises; only an explicit "cpu" runs on
    the CPU.

``num_cpu_devices`` (the JAX runtime's virtual CPU devices) raises
``SystemExit``: a replica is one process on one device, and the port's CPU
counterpart of an N-device mesh is N gloo ranks.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
from typing import Any, Optional

import torch

DEFAULT_SERVE_PORT = 8000

#: the JAX runtime's keys the port refuses -> why
_REFUSED = {
    "num_cpu_devices": "the port has no virtual CPU devices; its CPU counterpart of an "
                       "N-device mesh is N gloo ranks, one process each",
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
        from ..train.checkpoint import CheckpointConfig, Checkpointer

        path = ckpt if isinstance(ckpt, str) else ckpt.get("path")
        step = None if isinstance(ckpt, str) else ckpt.get("step")
        ro = Checkpointer(CheckpointConfig(directory=path), read_only=True)
        # the whole tree on the device, assembled from the rank files one
        # leaf at a time (serving is one device, as in the JAX package)
        raw, restored_step = ro.restore_raw(
            step=int(step) if step is not None else None, device=device, keys=("params",))
        return raw["params"], {
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

    for key, why in _REFUSED.items():
        if spec.get(key):
            raise SystemExit(f"{key}: {why}")
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


class ServeReporter(threading.Thread):
    """Ships engine traffic to the control plane every ``interval``: a
    heartbeat with the ``serve`` payload (always) and the run outputs
    (replica 0, so concurrent replicas don't clobber each other's keys) —
    the JAX runtime's reporter.

    Drain markers: the agent signals a scale-down drain by writing
    ``serve-drain-<replica>.json`` into the run dir; each report pass
    honours it (begin drain) or its removal (a cancelled scale-down:
    reopen admission). A marker's wall-clock ``expires_at`` keeps one
    orphaned by an agent crash from pinning a replica draining forever."""

    def __init__(self, run, engine, *, interval: float = 2.0,
                 replica: int = 0, port: int = 0):
        super().__init__(daemon=True, name="serve-reporter")
        self.tracked = run
        self.engine = engine
        self.interval = interval
        self.replica = replica
        self.port = port
        self._stop = threading.Event()
        self._marker_drain = False
        # each beat also records this replica's health numbers and ships
        # them with the heartbeat for the control plane's fleet history
        from ..obs.history import SeriesBuffer
        self._series_buf = SeriesBuffer()

    def stop(self) -> None:
        self._stop.set()
        self.report_once()  # final flush

    def _drain_marker_path(self) -> str:
        return os.path.join(self.tracked.run_dir,
                            f"serve-drain-{self.replica}.json")

    def _check_drain_marker(self) -> None:
        try:
            with open(self._drain_marker_path(), encoding="utf-8") as f:
                marker = json.load(f)
        except (OSError, ValueError):
            marker = None
        expired = (marker is not None
                   and marker.get("expires_at") is not None
                   # a wall timestamp the agent persisted on this host
                   and time.time() > float(marker["expires_at"]))
        if marker is not None and not expired:
            if not self._marker_drain and not self.engine.draining:
                self.engine.begin_drain()
            self._marker_drain = True
        elif self._marker_drain:
            # marker gone or past its horizon: reopen admission — only for
            # drains WE started (a SIGTERM drain is never cancelled)
            self._marker_drain = False
            if self.engine.draining:
                self.engine.end_drain()

    def report_once(self) -> None:
        try:
            self._check_drain_marker()
        except Exception:  # noqa: BLE001 — a marker must never stop the beat
            pass
        snap = self.engine.snapshot()
        obs = self.engine.drain_observations()
        payload = {**snap, **obs, "replica": self.replica}
        labels = {"replica": str(self.replica)}
        buf = self._series_buf
        buf.add("polyaxon_serve_requests_total",
                float(snap["requests_total"]), labels, kind="counter")
        buf.add("polyaxon_serve_rejected_total",
                float(snap["rejected_total"]), labels, kind="counter")
        buf.add("polyaxon_serve_running_requests", float(snap["running"]), labels)
        buf.add("polyaxon_serve_waiting_requests", float(snap["waiting"]), labels)
        buf.add("polyaxon_serve_kv_block_utilization",
                snap["kv_blocks_used"] / max(snap["kv_blocks_total"], 1), labels)
        try:
            self.tracked.heartbeat(serve=payload, metrics=buf.drain())
        except Exception:  # noqa: BLE001 — spool and retry live in tracking
            pass
        if self.replica == 0:
            outputs = {
                "serve_requests_total": snap["requests_total"],
                "serve_tokens_total": snap["tokens_total"],
                "serve_tokens_per_sec": round(snap["tokens_per_sec"], 3),
                "serve_ttft_p50_ms": snap["ttft_p50_ms"],
                "serve_ttft_p95_ms": snap["ttft_p95_ms"],
                "serve_intertoken_p50_ms": snap["intertoken_p50_ms"],
                "serve_intertoken_p95_ms": snap["intertoken_p95_ms"],
                "serve_running": snap["running"],
                "serve_waiting": snap["waiting"],
                "serve_kv_block_utilization": round(
                    snap["kv_blocks_used"] / max(snap["kv_blocks_total"], 1), 4),
                "serve_port": self.port,
                "serve_replica": self.replica,
                "serve_prefix_hit_rate": round(
                    snap["prefix_cache_hits"]
                    / max(snap["prefix_cache_hits"] + snap["prefix_cache_misses"], 1), 4),
                "serve_spec_acceptance_rate": round(
                    snap["spec_tokens_accepted"]
                    / max(snap["spec_tokens_proposed"], 1), 4),
            }
            try:
                self.tracked.log_outputs(**{
                    k: v for k, v in outputs.items() if v is not None})
            except Exception:  # noqa: BLE001
                pass

    def run(self) -> None:
        while not self._stop.wait(self.interval):
            self.report_once()


def _serve_watchdog(spec: dict, engine, run):
    """The decode-iteration watchdog of ``spec['watchdog']`` (on unless
    false), started, or None."""
    wd_spec = spec.get("watchdog", True)
    if wd_spec is False:
        return None
    from ..train.watchdog import StepWatchdog

    wd_kw = wd_spec if isinstance(wd_spec, dict) else {}

    def _log(line: str) -> None:
        if run is not None:
            try:
                run.log_line(line)
            except Exception:  # noqa: BLE001
                pass
        print(line, flush=True)

    def _on_stall(step: int, waited: float, limit: float) -> None:
        if run is None:
            return
        try:
            # the span covers the silent window itself (the durable
            # evidence: a running -> running status is a no-change edge
            # the store rejects); the status lands the reason in the logs
            now = time.time()
            run.log_span("serving_stalled", now - waited, now,
                         step=step, limit_s=round(limit, 3))
            run.log_status(
                "running", reason="ServingStalled",
                message=f"no decode iteration for {waited:.1f}s (limit "
                        f"{limit:.1f}s, step {step}); watchdog hard-exit -> "
                        f"retry budget")
            run.flush()
        except Exception:  # noqa: BLE001
            pass

    watchdog = StepWatchdog(
        stall_factor=float(wd_kw.get("stall_factor", 10.0)),
        min_s=float(wd_kw.get("min_s", 60.0)),
        compile_grace_s=float(wd_kw.get("compile_grace_s", 600.0)),
        p95_s=engine.step_p95_s, on_stall=_on_stall, log=_log)
    watchdog.start()
    return watchdog


class Replica:
    """One serving replica as :func:`start_replica` runs it: the engine,
    its HTTP server on ``port``, and, when the control plane launched it,
    the tracked ``run`` and its ``reporter``."""

    def __init__(self, engine, server, replica: int, run=None,
                 reporter: Optional[ServeReporter] = None, watchdog=None):
        self.engine = engine
        self.server = server
        self.port = server.server_address[1]
        self.replica = replica
        self.run = run
        self.reporter = reporter
        self.watchdog = watchdog

    def begin_drain(self) -> None:
        """Close admission and let the next heartbeat say so at once."""
        self.engine.begin_drain()
        if self.reporter is not None:
            self.reporter.report_once()

    def close(self) -> None:
        """Stop serving: the HTTP server, the watchdog (a clean shutdown
        must not read as a stall), the engine, a final traffic beat. The
        run's lifecycle stays the control plane's: another replica may
        still serve it."""
        self.server.shutdown()
        self.server.server_close()
        if self.watchdog is not None:
            self.watchdog.stop()
        self.engine.stop()
        if self.reporter is not None:
            self.reporter.stop()
        if self.run is not None:
            self.run.flush()


def start_replica(spec: dict[str, Any]) -> Replica:
    """Build the engine and serve it over HTTP on a thread, with the
    control-plane bridge when ``PLX_RUN_UUID`` is set: the tracked run,
    the endpoint file, the reporter; plus fault injection and the
    watchdog."""
    from .. import tracking
    from ..resilience.chaos import ServeChaos
    from .server import build_server

    engine = build_engine(spec)
    replica = int(os.environ.get("PLX_REPLICA_INDEX", "0"))
    run = tracking.get_run() if os.environ.get("PLX_RUN_UUID") else None
    engine.chaos = ServeChaos.from_spec(
        spec.get("chaos"), replica=replica,
        state_dir=run.run_dir if run is not None else None)
    watchdog = _serve_watchdog(spec, engine, run)
    engine.watchdog = watchdog
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
    reporter = None
    if run is not None:
        # publish the actual endpoint (replicas past 0 land on ephemeral
        # ports on a shared host)
        path = os.path.join(run.run_dir, f"serve-endpoint-{replica}.json")
        try:
            with open(path + ".tmp", "w", encoding="utf-8") as f:
                json.dump({"replica": replica, "port": actual_port,
                           "pid": os.getpid(), "at": time.time()}, f)
            os.replace(path + ".tmp", path)
        except OSError:
            pass
        run.log_status("running", reason="Serving",
                       message=f"replica {replica} on port {actual_port}")
        reporter = ServeReporter(
            run, engine, interval=float(spec.get("report_interval", 2.0)),
            replica=replica, port=actual_port)
        reporter.start()
    threading.Thread(target=srv.serve_forever, daemon=True, name="serve-http").start()
    return Replica(engine, srv, replica, run=run, reporter=reporter, watchdog=watchdog)


def run_serve(spec: dict[str, Any]) -> None:
    """Serve until SIGTERM/SIGINT, then drain: admission closes (/healthz
    503, and the next heartbeat says so at once), in-flight requests
    finish within ``drain_timeout_s``, and the server stops. A second
    signal stops immediately."""
    rep = start_replica(spec)
    engine = rep.engine
    stop_event = threading.Event()
    drain_timeout = float(spec.get("drain_timeout_s", 30.0))

    def _graceful(_sig, _frm):
        if drain_timeout <= 0 or engine.draining or stop_event.is_set():
            stop_event.set()
            return
        rep.begin_drain()

        def _await_drain():
            engine.await_drain(timeout=drain_timeout)
            stop_event.set()

        threading.Thread(target=_await_drain, daemon=True,
                         name="serve-drain").start()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)
    print(json.dumps({"serving": {"model": engine.model_name,
                                  "replica": rep.replica,
                                  "port": rep.port,
                                  "device": str(engine.device),
                                  "attn_impl": engine.attn_impl,
                                  **engine.provenance}}),
          flush=True)
    while not stop_event.wait(0.2):
        pass
    rep.close()


def main() -> None:
    """The pod entry of a ``kind: service`` runtime: the spec as JSON in
    ``PLX_SERVE_SPEC``."""
    raw = os.environ.get("PLX_SERVE_SPEC")
    if not raw:
        raise SystemExit("PLX_SERVE_SPEC not set")
    run_serve(json.loads(raw))


if __name__ == "__main__":
    main()
