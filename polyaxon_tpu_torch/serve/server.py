"""HTTP front for a :class:`ServeEngine` on the standard library's
``http.server`` — the port's twin of ``polyaxon_tpu/serve/server.py``
(which runs on aiohttp), with the same routes, JSON shapes and status
codes.

Routes:
    POST /generate   {"prompt": "text"} or {"tokens": [ints]}, plus
                     per-request sampling params (max_new_tokens,
                     temperature, top_k, seed, stop_token),
                     "stream": true for NDJSON token streaming,
                     "request_id" (client idempotency id) and
                     "deadline_s" (server-side cancel + KV recycle).
                     503 while draining, 429 with a Retry-After header
                     when the bounded admission queue is full.
    GET  /result/{request_id}   the finished result from the completed
                     cache (202 while still generating, 404 when unknown).
    GET  /healthz    200 only when the engine completed a first
                     successful step AND is not draining, else 503.
    GET  /stats      engine traffic snapshot (JSON twin of /metrics).
    GET  /metrics    Prometheus text of the engine's registry.

Each connection is served on its own thread (``ThreadingHTTPServer``);
a handler blocks on the request's completion latch or token stream while
the engine thread generates.

Tokenization: byte-vocab models (vocab_size == 256) treat prompt text as
its UTF-8 bytes and detokenize through latin-1. Larger vocabs accept and
return raw token ids only.
"""

from __future__ import annotations

import json
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .engine import (
    EngineDrainingError, EngineOverloadedError, SamplingParams, ServeEngine,
)


def encode_prompt(body: dict, vocab_size: int) -> list[int]:
    if body.get("tokens") is not None:
        return [int(t) for t in body["tokens"]]
    prompt = body.get("prompt")
    if prompt is None:
        raise ValueError("body needs 'prompt' (text) or 'tokens' (ids)")
    return [b % vocab_size for b in str(prompt).encode("utf-8")]


def decode_tokens(tokens: list[int], vocab_size: int) -> Optional[str]:
    if vocab_size != 256:
        return None
    return bytes(t % 256 for t in tokens).decode("latin-1")


def _request_stats(req) -> dict:
    total_s = ((req.finished_at or time.monotonic()) - req.created_at)
    decode_s = None
    if req.first_token_at is not None and req.last_token_at is not None:
        decode_s = req.last_token_at - req.first_token_at
    n = len(req.out_tokens)
    return {
        "num_tokens": n,
        "ttft_ms": (round(req.ttft_s * 1e3, 3)
                    if req.ttft_s is not None else None),
        "total_ms": round(total_s * 1e3, 3),
        # steady-state decode rate (first token excluded: it pays prefill)
        "tokens_per_sec": (round((n - 1) / decode_s, 3)
                           if decode_s and n > 1 else None),
    }


def _result_body(req, vocab: int, cached: bool = False) -> dict:
    out = {"tokens": req.out_tokens, **_request_stats(req)}
    if req.request_id:
        out["request_id"] = req.request_id
    if cached:
        out["cached"] = True
    text = decode_tokens(req.out_tokens, vocab)
    if text is not None:
        out["text"] = text
    return out


class _Handler(BaseHTTPRequestHandler):
    """Routes of one server; ``engine`` and ``model_name`` come from the
    subclass :func:`build_server` makes."""

    engine: ServeEngine
    model_name: str = ""

    def log_message(self, format, *args):  # noqa: A002 — stdlib signature
        pass  # one line per request on stderr is noise for a server

    def _json(self, status: int, body: dict,
              headers: Optional[dict] = None) -> None:
        data = json.dumps(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _finished(self, req, cached: bool) -> None:
        req.done.wait()
        if req.error:
            self._json(500, {"error": req.error,
                             **({"request_id": req.request_id}
                                if req.request_id else {})})
            return
        self._json(200, _result_body(req, self.engine.cfg.vocab_size,
                                     cached=cached))

    def do_GET(self):  # noqa: N802 — stdlib name
        engine = self.engine
        path = self.path.split("?", 1)[0]
        if path == "/healthz":
            ok = engine.ready and not engine.draining
            self._json(200 if ok else 503, {
                "ok": ok, "model": self.model_name,
                "ready": engine.ready,
                "draining": engine.draining,
                "running": engine.running_count,
                "waiting": engine.waiting_count,
                "speculative_k": 0,
                "prefix_cache": engine.cache.prefix_index is not None,
            })
        elif path == "/stats":
            self._json(200, engine.snapshot())
        elif path == "/metrics":
            data = engine.metrics.render().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; charset=utf-8")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        elif path.startswith("/result/"):
            req = engine.lookup(path[len("/result/"):])
            if req is None:
                self._json(404, {"error": "unknown request_id"})
            elif req.state not in ("done", "failed"):
                self._json(202, {"state": req.state, "done": False,
                                 "request_id": req.request_id})
            elif req.error:
                self._json(500, {"error": req.error,
                                 "request_id": req.request_id})
            else:
                self._json(200, _result_body(
                    req, engine.cfg.vocab_size, cached=True))
        else:
            self._json(404, {"error": f"no route {path}"})

    def do_POST(self):  # noqa: N802 — stdlib name
        if self.path.split("?", 1)[0] != "/generate":
            self._json(404, {"error": f"no route {self.path}"})
            return
        engine = self.engine
        vocab = engine.cfg.vocab_size
        try:
            n = int(self.headers.get("Content-Length") or 0)
            body = json.loads(self.rfile.read(n) or b"null")
        except ValueError:
            self._json(400, {"error": "invalid JSON body"})
            return
        if not isinstance(body, dict):
            self._json(400, {"error": "body must be an object"})
            return
        try:
            tokens = encode_prompt(body, vocab)
            sp = SamplingParams.from_dict(body)
        except (ValueError, TypeError) as e:
            self._json(400, {"error": str(e)})
            return
        rid = body.get("request_id")
        rid = str(rid) if rid is not None else None
        deadline_s = body.get("deadline_s")
        try:
            req, created = engine.submit_request(
                tokens, sp, request_id=rid,
                deadline_s=(float(deadline_s) if deadline_s else None))
        except EngineDrainingError as e:
            self._json(503, {"error": str(e), "draining": True})
            return
        except EngineOverloadedError as e:
            # shed with an honest backoff hint, never an unbounded queue
            self._json(429, {"error": str(e),
                             "retry_after_s": e.retry_after_s},
                       headers={"Retry-After":
                                str(max(int(-(-e.retry_after_s // 1)), 1))})
            return
        if not created:
            # idempotent retry of a live or finished id: wait on the
            # terminal latch — the ORIGINAL submitter owns the stream
            self._finished(req, cached=True)
            return
        if req.state == "failed":
            self._json(400, {"error": req.error})
            return
        if not body.get("stream"):
            self._finished(req, cached=False)
            return
        # NDJSON stream: one {"token": t} line per token, then a final
        # {"done": true, ...} line; the connection closes at the end
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.end_headers()
        while True:
            tok = req.stream.get()
            if tok is None:
                break
            self.wfile.write((json.dumps({"token": tok}) + "\n").encode())
            self.wfile.flush()
        final = {"done": True, **_result_body(req, vocab)}
        if req.error:
            final["error"] = req.error
        self.wfile.write((json.dumps(final) + "\n").encode())
        self.wfile.flush()


def build_server(engine: ServeEngine, host: str = "127.0.0.1",
                 port: int = 0, *, model_name: str = "") -> ThreadingHTTPServer:
    """A threading HTTP server bound to ``(host, port)`` (port 0 takes an
    ephemeral one). The caller runs ``serve_forever()`` and later
    ``shutdown()`` + ``server_close()``."""
    handler = type("ServeHandler", (_Handler,),
                   {"engine": engine, "model_name": model_name})
    srv = ThreadingHTTPServer((host, port), handler)
    srv.daemon_threads = True
    return srv
