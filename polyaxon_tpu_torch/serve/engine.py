"""Continuous (iteration-level) batching engine — port of
``polyaxon_tpu/serve/engine.py``.

Orca-style scheduling: the unit of work is one *decode iteration* over the
running batch, and the request set is re-evaluated between iterations —
new requests admit the moment a slot and blocks are free, finished requests
release their blocks the same iteration they complete, and a long prompt
prefills in bounded chunks interleaved with decode so it can never stall
the running batch for more than one chunk's worth of compute.

The scheduler is host Python, the same as the JAX package's; only the
device calls differ (:meth:`ServeEngine._prefill_step`,
:meth:`ServeEngine._decode_batch` and :meth:`ServeEngine._decode_batch_spec`
call the port's ``prefill_chunk``, ``decode_step`` and ``verify_step`` on
the engine's device). Sampling stays on the host (numpy).

Speculative decoding (``draft_params``, ``draft_cfg``, ``spec_k``): a small
draft proposes ``spec_k`` tokens per iteration, greedily, over its own
mirrored paged cache; the target scores pending token + proposals in one
batched ``verify_step``, and each greedy row emits the longest agreeing
prefix plus the target's own correction — token for token what plain
decode emits, with fewer target steps per token.

Block accounting is worst-case at admission (prompt + max_new_tokens): a
request that admits can always finish. Request-path fault tolerance:
idempotency ids (``request_id``), deadlines and server-side cancel, a
bounded waiting queue with a throughput-derived Retry-After
(:class:`EngineOverloadedError`), KV-pressure preemption of the newest
running sequence, and drain (``begin_drain`` / ``end_drain``). Prefix
sharing maps cached full prompt blocks into a new request's table at
admission. The loop beats an optional step ``watchdog`` and gives an
optional ``chaos`` hook its chance to hang after each iteration.
"""

from __future__ import annotations

import collections
import itertools
import queue
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from ..models.transformer import TransformerConfig
from ..obs.metrics import MetricsRegistry
from .kv_cache import OutOfBlocksError, SequenceBlocks
from .model import decode_step, init_cache, prefill_chunk, serving_params, verify_step


#: finished request ids kept resumable by id (``/result/{id}``)
COMPLETED_CACHE = 256


class EngineOverloadedError(RuntimeError):
    """The bounded waiting queue is full — shed, don't queue unboundedly.
    ``retry_after_s`` is the throughput-derived backoff hint the server
    forwards as a 429 Retry-After header."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class EngineDrainingError(RuntimeError):
    """The engine is draining: admission is closed (the server answers
    503 so probes/fronts route elsewhere); accepted work still finishes."""


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs (vLLM's SamplingParams, trimmed)."""

    max_new_tokens: int = 64
    temperature: float = 0.0      # 0 = greedy
    top_k: int = 0                # 0 = full vocab
    seed: Optional[int] = None
    stop_token: Optional[int] = None

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "SamplingParams":
        d = d or {}
        return cls(
            max_new_tokens=int(d.get("max_new_tokens", 64)),
            temperature=float(d.get("temperature", 0.0)),
            top_k=int(d.get("top_k", 0)),
            seed=(int(d["seed"]) if d.get("seed") is not None else None),
            stop_token=(int(d["stop_token"])
                        if d.get("stop_token") is not None else None),
        )


# request lifecycle: waiting -> prefill -> running -> done|failed
# (a KV-pressure preemption moves running/prefill back to waiting)
@dataclass
class GenRequest:
    id: int
    prompt: list[int]
    sampling: SamplingParams
    created_at: float = field(default_factory=time.monotonic)
    state: str = "waiting"
    seq: SequenceBlocks = field(default_factory=SequenceBlocks)
    prefilled: int = 0
    next_token: Optional[int] = None    # sampled, not yet cache-written
    out_tokens: list[int] = field(default_factory=list)
    stream: "queue.SimpleQueue" = field(default_factory=queue.SimpleQueue)
    first_token_at: Optional[float] = None
    last_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    error: Optional[str] = None
    # client idempotency id: dedupes retried submissions and keys the
    # completed-request cache for resume-by-id
    request_id: Optional[str] = None
    # absolute monotonic deadline; past it the engine cancels the request
    # server-side and recycles its blocks the same step
    deadline: Optional[float] = None
    preemptions: int = 0
    # terminal-state latch: resumed/attached waiters block on this instead
    # of splitting the (single-consumer) token stream queue
    done: "threading.Event" = field(default_factory=threading.Event)
    # prefix to re-prefill after a preemption (prompt + emitted tokens
    # minus the pending next_token); None for a first admission
    _resume_prefix: Optional[list] = None
    _rng: Optional[np.random.Generator] = None
    # speculative decoding: the draft model's mirror of this sequence in
    # the draft KV cache, with its own prefill cursor
    draft_seq: SequenceBlocks = field(default_factory=SequenceBlocks)
    draft_prefilled: int = 0

    @property
    def rng(self) -> np.random.Generator:
        if self._rng is None:
            seed = self.sampling.seed
            self._rng = np.random.default_rng(
                self.id if seed is None else seed)
        return self._rng

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.created_at


def sample_token(logits: np.ndarray, sp: SamplingParams,
                 rng: np.random.Generator) -> int:
    """Host-side sampling: greedy at temperature 0, else softmax with
    optional top-k, per-request PRNG (deterministic under a seed)."""
    if sp.temperature <= 0.0:
        return int(np.argmax(logits))
    x = logits.astype(np.float64) / sp.temperature
    if sp.top_k and sp.top_k < x.shape[-1]:
        kth = np.partition(x, -sp.top_k)[-sp.top_k]
        x = np.where(x >= kth, x, -np.inf)
    x = x - x.max()
    p = np.exp(x)
    p /= p.sum()
    return int(rng.choice(x.shape[-1], p=p))


class ServeEngine:
    """Paged-KV continuous-batching engine over a fixed slot count.

    ``step()`` is one scheduling iteration (admission + at most one prefill
    chunk + one batched decode); ``start()`` runs it on a daemon thread.
    ``submit()``/``generate()`` are thread-safe. The model and the KV
    pools run on the device that ``params`` live on (all on one device;
    they are never moved); the matrix weights are cast to ``cfg.dtype``.
    """

    def __init__(
        self,
        params: Any,
        cfg: TransformerConfig,
        *,
        max_slots: int = 8,
        block_size: int = 16,
        num_blocks: Optional[int] = None,
        prefill_chunk: int = 64,
        max_seq_len: Optional[int] = None,
        attn_impl: str = "gather",
        max_waiting: int = 128,
        preempt_grace_s: float = 2.0,
        enable_prefix_cache: bool = True,
        draft_params: Any = None,
        draft_cfg: Optional[TransformerConfig] = None,
        spec_k: int = 0,
    ):
        self.device = params_device(params)
        self.cfg = cfg
        self.params = serving_params(params, cfg)
        self.max_slots = int(max_slots)
        self.block_size = int(block_size)
        self.max_seq_len = int(max_seq_len or cfg.max_seq)
        self.max_blocks_per_seq = -(-self.max_seq_len // self.block_size)
        if num_blocks is None:
            # enough for every slot to hold a worst-case sequence
            num_blocks = self.max_slots * self.max_blocks_per_seq
        self.prefill_chunk = int(prefill_chunk)
        if attn_impl not in ("gather", "flash"):
            raise ValueError(f"unknown attn_impl {attn_impl!r}; "
                             f"valid: gather|flash")
        self.attn_impl = attn_impl
        self.cache = init_cache(cfg, num_blocks=int(num_blocks),
                                block_size=self.block_size,
                                enable_prefix_cache=enable_prefix_cache,
                                device=self.device)
        # -- speculative decoding ---------------------------------------------
        # the draft keeps its own (mirrored) paged cache on the same device;
        # worst-case reservations carry a +spec_k margin because a verify
        # writes K/V up to spec_k positions past the accepted length
        # (masked garbage until the next step overwrites it)
        self.spec_k = int(spec_k) if draft_params is not None else 0
        self.draft_params = None
        self.draft_cfg = None
        self.draft_cache = None
        if self.spec_k > 0:
            if draft_cfg is None:
                raise ValueError("draft_params needs draft_cfg")
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab {draft_cfg.vocab_size} != target vocab "
                    f"{cfg.vocab_size}: proposals would be meaningless")
            if draft_cfg.max_seq < self.max_seq_len:
                from dataclasses import replace

                draft_cfg = replace(draft_cfg, max_seq=self.max_seq_len)
            if params_device(draft_params) != self.device:
                raise ValueError(
                    f"draft params live on {params_device(draft_params)}, the "
                    f"target's on {self.device}")
            self.draft_cfg = draft_cfg
            self.draft_params = serving_params(draft_params, draft_cfg)
            self.draft_cache = init_cache(
                draft_cfg, num_blocks=int(num_blocks), block_size=self.block_size,
                enable_prefix_cache=enable_prefix_cache, device=self.device)
        self._slots: list[Optional[GenRequest]] = [None] * self.max_slots
        self._waiting: collections.deque[GenRequest] = collections.deque()
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._work = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

        # -- request-path fault tolerance ------------------------------------
        self.max_waiting = int(max_waiting)
        self.preempt_grace_s = float(preempt_grace_s)
        self._by_rid: dict[str, GenRequest] = {}   # in-flight + done
        self._rid_done: collections.deque = collections.deque()
        self._draining = False
        self._ready = threading.Event()    # first successful step done
        self._blocked_since: Optional[float] = None  # head-of-line starving
        # working-step durations feeding the watchdog's p95-scaled stall
        # deadline; the first two worked steps build and warm the kernels
        # and are left out, or one slow sample would lift the deadline for
        # the replica's whole life
        self._worked_steps = 0
        self._step_durations: collections.deque = collections.deque(maxlen=256)
        #: optional train.watchdog.StepWatchdog the loop beats; attach
        #: before start()
        self.watchdog = None
        #: optional resilience.ServeChaos hook (fault injection)
        self.chaos = None
        # raw TTFT / inter-token samples since the last heartbeat drain
        # (bounded: a replica whose reporter is slow keeps the newest)
        self._obs_lock = threading.Lock()
        self._ttft_obs: collections.deque = collections.deque(maxlen=512)
        self._itl_obs: collections.deque = collections.deque(maxlen=2048)

        # -- meters ----------------------------------------------------------
        self.metrics = MetricsRegistry()
        self._h_ttft = self.metrics.histogram(
            "polyaxon_serve_ttft_seconds",
            "Request arrival to first generated token")
        self._h_itl = self.metrics.histogram(
            "polyaxon_serve_intertoken_seconds",
            "Interval between consecutive generated tokens of one request")
        self._c_requests = self.metrics.counter(
            "polyaxon_serve_requests_total", "Generate requests completed")
        self._c_tokens = self.metrics.counter(
            "polyaxon_serve_generated_tokens_total", "Tokens generated")
        self.metrics.gauge(
            "polyaxon_serve_running_requests",
            "Requests holding a decode slot",
            value_fn=lambda: float(self.running_count))
        self.metrics.gauge(
            "polyaxon_serve_waiting_requests",
            "Requests queued for admission",
            value_fn=lambda: float(self.waiting_count))
        self.metrics.gauge(
            "polyaxon_serve_kv_block_utilization",
            "Fraction of KV cache blocks reserved",
            value_fn=lambda: self.cache.utilization)
        self._c_rejected = self.metrics.counter(
            "polyaxon_serve_rejected_total",
            "Generate requests shed at admission (bounded queue, 429)")
        self._c_preempted = self.metrics.counter(
            "polyaxon_serve_preemptions_total",
            "Running sequences evicted back to waiting under KV pressure")
        self.metrics.gauge(
            "polyaxon_serve_draining",
            "1 while this replica is draining (admission closed)",
            value_fn=lambda: 1.0 if self._draining else 0.0)
        self._c_prefix_hits = self.metrics.counter(
            "polyaxon_serve_prefix_cache_hits_total",
            "Full prompt blocks mapped from the prefix cache at admission "
            "(refcount++, no re-prefill)")
        self._c_prefix_misses = self.metrics.counter(
            "polyaxon_serve_prefix_cache_misses_total",
            "Full prompt blocks prefilled because the prefix cache had no "
            "chain for them")
        self.metrics.gauge(
            "polyaxon_serve_shared_kv_blocks",
            "KV blocks currently referenced by more than one holder "
            "(sequences and/or the prefix index)",
            value_fn=lambda: float(self.cache.allocator.shared_count))
        self._c_cow = self.metrics.counter(
            "polyaxon_serve_cow_copies_total",
            "Copy-on-write block copies (a write into a shared block)",
            value_fn=lambda: float(self.cache.cow_copies + (
                self.draft_cache.cow_copies if self.draft_cache is not None else 0)))
        self._c_spec_proposed = self.metrics.counter(
            "polyaxon_serve_spec_tokens_proposed_total",
            "Draft tokens proposed to the speculative verify step")
        self._c_spec_accepted = self.metrics.counter(
            "polyaxon_serve_spec_tokens_accepted_total",
            "Draft tokens accepted by the target's verify step")
        self._decode_steps = 0
        self._started_at = time.monotonic()

    # -- public surface ------------------------------------------------------

    @property
    def running_count(self) -> int:
        return sum(1 for r in self._slots if r is not None)

    @property
    def waiting_count(self) -> int:
        return len(self._waiting)

    @property
    def decode_steps(self) -> int:
        """Batched decode iterations run so far (one ``decode_step`` each;
        a speculative iteration is one ``verify_step`` after ``spec_k + 1``
        draft decode steps)."""
        return self._decode_steps

    @property
    def ready(self) -> bool:
        """True once the engine completed its first successful step that
        processed work — the /healthz readiness signal."""
        return self._ready.is_set()

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def drained(self) -> bool:
        """Draining AND empty: every accepted request finished."""
        with self._lock:
            return (self._draining and not self._waiting
                    and all(r is None for r in self._slots))

    def begin_drain(self) -> None:
        """Close admission; accepted requests run to completion."""
        with self._lock:
            self._draining = True
        self._work.set()

    def end_drain(self) -> None:
        """Reopen admission (a cancelled scale-down)."""
        with self._lock:
            self._draining = False

    def await_drain(self, timeout: float = 30.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.drained:
                return True
            time.sleep(0.05)
        return self.drained

    def lookup(self, request_id: Optional[str]) -> Optional[GenRequest]:
        """The live or cached request for an idempotency id (resume-by-id)."""
        if not request_id:
            return None
        with self._lock:
            return self._by_rid.get(request_id)

    def _fail_new(self, req: GenRequest, error: str) -> GenRequest:
        req.state = "failed"
        req.error = error
        req.finished_at = time.monotonic()
        req.stream.put(None)
        req.done.set()
        return req

    def submit_request(
        self, prompt: list[int],
        sampling: Optional[SamplingParams] = None,
        *,
        request_id: Optional[str] = None,
        deadline_s: Optional[float] = None,
    ) -> tuple[GenRequest, bool]:
        """Admit (or dedupe) one request. Returns ``(req, created)`` —
        ``created`` is False when ``request_id`` matched a live or cached
        request (the caller must then wait on ``req.done``, never drain
        the stream it doesn't own). Raises
        :class:`EngineDrainingError` / :class:`EngineOverloadedError`."""
        sampling = sampling or SamplingParams()
        vocab = self.cfg.vocab_size
        prompt = [int(t) % vocab for t in prompt]
        req = GenRequest(id=next(self._ids), prompt=prompt,
                         sampling=sampling,
                         request_id=request_id,
                         deadline=(time.monotonic() + float(deadline_s)
                                   if deadline_s else None))
        if not prompt:
            return self._fail_new(req, "empty prompt"), True
        # +spec_k: a speculative verify writes K/V up to spec_k positions
        # past the accepted length, so reservations (and the max-seq bound)
        # carry that margin
        total = len(prompt) + sampling.max_new_tokens + self.spec_k
        if total > self.max_seq_len:
            return self._fail_new(
                req, f"prompt+max_new_tokens {total} exceeds "
                     f"max_seq_len {self.max_seq_len}"), True
        if not self.cache.allocator.can_ever_alloc(
                self.cache.blocks_for(total)):
            # can NEVER admit even with the whole pool free: fail loudly
            # instead of deadlocking the head of the queue forever
            return self._fail_new(
                req, f"worst-case reservation "
                     f"{self.cache.blocks_for(total)} blocks exceeds the "
                     f"pool ({self.cache.allocator.num_blocks})"), True
        with self._lock:
            if request_id:
                existing = self._by_rid.get(request_id)
                if existing is not None:
                    return existing, False
            if self._draining:
                raise EngineDrainingError(
                    "replica is draining; admission closed")
            if len(self._waiting) >= self.max_waiting:
                self._c_rejected.inc()
                raise EngineOverloadedError(
                    f"waiting queue full ({self.max_waiting})",
                    retry_after_s=self._retry_after_locked())
            self._waiting.append(req)
            if request_id:
                self._by_rid[request_id] = req
        self._work.set()
        return req, True

    def submit(self, prompt: list[int],
               sampling: Optional[SamplingParams] = None,
               *,
               request_id: Optional[str] = None,
               deadline_s: Optional[float] = None) -> GenRequest:
        return self.submit_request(prompt, sampling, request_id=request_id,
                                   deadline_s=deadline_s)[0]

    def cancel(self, req: GenRequest, reason: str = "cancelled") -> bool:
        """Cancel a live request SERVER-side: recycle its blocks and free
        its slot immediately. Returns False when the request already
        finished."""
        with self._lock:
            return self._cancel_locked(req, reason)

    def _cancel_locked(self, req: GenRequest, reason: str) -> bool:
        if req.state in ("done", "failed"):
            return False
        try:
            self._waiting.remove(req)
        except ValueError:
            pass
        for i, r in enumerate(self._slots):
            if r is req:
                self._slots[i] = None
        self._release(req)
        req.state = "failed"
        req.error = reason
        req.finished_at = time.monotonic()
        req.stream.put(None)
        req.done.set()
        self._note_done_locked(req)
        return True

    def generate(self, prompt: list[int],
                 sampling: Optional[SamplingParams] = None,
                 timeout: float = 120.0,
                 request_id: Optional[str] = None) -> GenRequest:
        """Blocking helper: submit and drain the stream to completion.
        A timeout CANCELS the request server-side. A ``request_id``
        matching a live/cached request ATTACHES (waits on the terminal
        latch — the original submitter owns the stream)."""
        req, created = self.submit_request(prompt, sampling,
                                           request_id=request_id)
        if not created:
            if not req.done.wait(timeout):
                raise TimeoutError(
                    f"attached request {request_id} still running after "
                    f"{timeout}s")
            return req
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                self.cancel(req, f"generate timed out after {timeout}s")
                raise TimeoutError(f"generate timed out after {timeout}s")
            try:
                tok = req.stream.get(timeout=min(remaining, 1.0))
            except queue.Empty:
                continue
            if tok is None:
                return req

    def start(self) -> "ServeEngine":
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="serve-engine")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._work.set()
        if self._thread is not None:
            self._thread.join(timeout=30)

    # -- scheduling ----------------------------------------------------------

    def _admit(self) -> None:
        """Move waiting requests into free slots while blocks last —
        between iterations, never mid-iteration (Orca admission rule).

        Prefix sharing: admission first maps every cached full prefix
        block into the request's table (refcount++, zero copies), then
        allocates only the remainder; ``prefilled`` starts at the first
        unshared token. When the cache covers the whole prompt
        block-aligned, the block holding the LAST prompt token is COW'd up
        front — the only position prefill ever writes inside shared
        territory."""
        for i in range(self.max_slots):
            if not self._waiting or self._slots[i] is not None:
                continue
            req = self._waiting[0]
            total = (len(req.prompt) + req.sampling.max_new_tokens
                     + self.spec_k)
            # a preempted request re-prefills its whole emitted prefix
            # (recompute-on-readmit) minus the pending next_token, whose
            # K/V the first post-resume decode step writes
            src = (req.prompt + req.out_tokens[:-1]
                   if req.out_tokens else req.prompt)
            shared = self.cache.share_prefix(req.seq, src)
            d_shared = (self.draft_cache.share_prefix(req.draft_seq, src)
                        if self.draft_cache is not None else 0)
            try:
                self.cache.ensure(req.seq, total)
                if self.draft_cache is not None:
                    self.draft_cache.ensure(req.draft_seq, total)
                start = min(shared, len(src) - 1)
                if shared > start:
                    # fully-covered prompt: prefill still recomputes the
                    # last token (its logits seed generation) — the write
                    # into the shared tail block must COW first
                    self.cache.ensure_writable(req.seq, start)
                d_start = min(d_shared, len(src) - 1)
                if d_shared > d_start and self.draft_cache is not None:
                    self.draft_cache.ensure_writable(req.draft_seq, d_start)
            except OutOfBlocksError:
                # roll the mapping back (decref) and keep FIFO order
                self._release(req)
                return
            bs = self.block_size
            self._c_prefix_hits.inc(shared // bs)
            self._c_prefix_misses.inc(
                self.cache.blocks_for(len(src)) - shared // bs)
            self._waiting.popleft()
            req.state = "prefill"
            req._resume_prefix = src if req.out_tokens else None
            req.prefilled = start
            req.seq.length = start
            if self.draft_cache is not None:
                req.draft_prefilled = d_start
                req.draft_seq.length = d_start
            self._blocked_since = None
            self._slots[i] = req

    def _expire_deadlines(self, now: float) -> None:
        """Cancel every request past its deadline — waiting or holding a
        slot — recycling blocks the same iteration."""
        expired = [r for r in list(self._waiting) + list(self._slots)
                   if r is not None and r.deadline is not None
                   and now > r.deadline]
        for r in expired:
            self._cancel_locked(r, "deadline exceeded")

    def _maybe_preempt(self, now: float) -> None:
        """KV-pressure relief: when the head-of-line waiting request has a
        free slot but no blocks past ``preempt_grace_s``, evict the NEWEST
        running sequence back to ``waiting`` BEHIND the starving head
        (recompute-on-readmit). A request is evicted at most once in its
        lifetime — bounded churn, no preempt/readmit livelock."""
        if not self._waiting:
            self._blocked_since = None
            return
        head = self._waiting[0]
        if not any(s is None for s in self._slots):
            self._blocked_since = None  # slot-starved, not block-starved
            return
        total = (len(head.prompt) + head.sampling.max_new_tokens
                 + self.spec_k)
        short = self.cache.blocks_short(head.seq, total)
        if self.cache.free_plus_evictable() >= short:
            # admission's own eviction path will reclaim index-only blocks
            self._blocked_since = None
            return
        if self._blocked_since is None:
            self._blocked_since = now
            return
        if now - self._blocked_since < self.preempt_grace_s:
            return
        if any(w.preemptions > 0 for w in self._waiting):
            # one outstanding eviction at a time
            return
        victims = [(i, r) for i, r in enumerate(self._slots)
                   if r is not None and r.preemptions == 0
                   and self.cache.free_plus_evictable()
                   + self.cache.reclaimable_on_release(r.seq) >= short]
        if not victims:
            return
        i, victim = max(victims, key=lambda t: t[1].id)
        self._preempt_locked(i, victim)
        self._blocked_since = now  # fresh grace before the next eviction

    def _preempt_locked(self, slot: int, req: GenRequest) -> None:
        # release is a DECREF: blocks the victim shared with the prefix
        # index or another sequence survive at their remaining refcount
        self._release(req)
        req.prefilled = 0
        req.draft_prefilled = 0
        req.state = "waiting"
        req.preemptions += 1
        self._slots[slot] = None
        # BEHIND the starving head (it takes the freed blocks)
        self._waiting.insert(min(1, len(self._waiting)), req)
        self._c_preempted.inc()

    def _retry_after_locked(self) -> float:
        """429 Retry-After hint: outstanding worst-case decode work over
        the observed token throughput, clamped to a sane window."""
        outstanding = sum(
            r.sampling.max_new_tokens - len(r.out_tokens)
            for r in list(self._waiting) + list(self._slots)
            if r is not None)
        elapsed = max(time.monotonic() - self._started_at, 1e-9)
        tps = self._c_tokens.value / elapsed
        return min(max(outstanding / max(tps, 1.0), 1.0), 60.0)

    def _tensor(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(array).to(self.device)

    def _release(self, req: GenRequest) -> None:
        """Return a request's blocks (target and draft) to the pools."""
        self.cache.release(req.seq)
        if self.draft_cache is not None:
            self.draft_cache.release(req.draft_seq)

    def _prefill_step(self, params, cfg, cache, seq: SequenceBlocks,
                      src: list, prefilled: int):
        """One bounded prefill chunk of ``src`` into ``cache`` starting at
        ``prefilled``; returns (last-chunk logits, new prefilled)."""
        c = self.prefill_chunk
        chunk = src[prefilled:prefilled + c]
        padded = np.zeros((1, c), np.int64)
        padded[0, :len(chunk)] = chunk
        tables = self._tensor(cache.block_table_array(
            [seq], self.max_blocks_per_seq))
        logits = prefill_chunk(
            params, self._tensor(padded), prefilled, len(chunk),
            cache.k, cache.v, tables, cfg=cfg)
        return logits, prefilled + len(chunk)

    def _prefill_one(self) -> bool:
        """Advance the first mid-prefill request by one bounded chunk —
        the target's prompt first, then (speculative mode) the draft's
        mirror of it. Returns True when it advanced one."""
        req = next((r for r in self._slots
                    if r is not None and r.state == "prefill"), None)
        if req is None:
            return False
        src = (req._resume_prefix if req._resume_prefix is not None
               else req.prompt)
        if req.prefilled < len(src):
            logits, req.prefilled = self._prefill_step(
                self.params, self.cfg, self.cache, req.seq, src, req.prefilled)
            # readiness flips BEFORE any token is emitted: a client that
            # got its answer may probe /healthz before the end of this
            # iteration
            self._ready.set()
            req.seq.length = req.prefilled
            if req.prefilled >= len(src):
                # the prompt's full blocks are frozen from here (writes
                # only ever land past len(src)): publish them so later
                # prompts sharing the prefix skip their re-prefill
                self.cache.publish_prefix(req.seq, req.prompt)
                if req.out_tokens:
                    # resumed after a preemption: every emitted token
                    # already left through the stream — rearm the pending
                    # next_token
                    req.next_token = req.out_tokens[-1]
                else:
                    tok = sample_token(logits[0].cpu().numpy(), req.sampling,
                                       req.rng)
                    req.next_token = tok
                    self._emit(req, tok)
        elif self.draft_cache is not None:
            _, req.draft_prefilled = self._prefill_step(
                self.draft_params, self.draft_cfg, self.draft_cache,
                req.draft_seq, src, req.draft_prefilled)
            req.draft_seq.length = req.draft_prefilled
            if req.draft_prefilled >= len(src):
                self.draft_cache.publish_prefix(req.draft_seq, req.prompt)
        if req.prefilled >= len(src) and (
                self.draft_cache is None or req.draft_prefilled >= len(src)):
            req.state = "running"
            req._resume_prefix = None
        return True

    def _decode_batch(self) -> int:
        """One decode iteration over every running slot. Returns tokens
        emitted."""
        if self.draft_cache is not None:
            return self._decode_batch_spec()
        running = [(i, r) for i, r in enumerate(self._slots)
                   if r is not None and r.state == "running"]
        if not running:
            return 0
        b = self.max_slots
        tokens = np.zeros(b, np.int64)
        positions = np.zeros(b, np.int64)
        active = np.zeros(b, bool)
        for i, r in running:
            tokens[i] = r.next_token
            positions[i] = r.seq.length
            active[i] = True
        seqs: list[Optional[SequenceBlocks]] = [
            r.seq if r is not None else None for r in self._slots]
        tables = self._tensor(self.cache.block_table_array(
            seqs, self.max_blocks_per_seq))
        logits = decode_step(
            self.params, self._tensor(tokens), self._tensor(positions),
            self.cache.k, self.cache.v, tables, self._tensor(active),
            cfg=self.cfg, impl=self.attn_impl)
        logits_np = logits.cpu().numpy()
        self._decode_steps += 1
        emitted = 0
        for i, r in running:
            r.seq.length += 1  # the input token's K/V just landed
            sp = r.sampling
            done = len(r.out_tokens) >= sp.max_new_tokens or (
                sp.stop_token is not None
                and r.out_tokens and r.out_tokens[-1] == sp.stop_token)
            if done:
                self._finish(i, r)
                continue
            tok = sample_token(logits_np[i], sp, r.rng)
            r.next_token = tok
            self._emit(r, tok)
            emitted += 1
            if len(r.out_tokens) >= sp.max_new_tokens or (
                    sp.stop_token is not None and tok == sp.stop_token):
                self._finish(i, r)
        return emitted

    def _decode_batch_spec(self) -> int:
        """One SPECULATIVE iteration: the draft greedily proposes
        ``spec_k`` tokens per running row, the target scores pending token
        + proposals in ONE batched :func:`verify_step`, and each greedy row
        emits the longest prefix of proposals agreeing with the target's
        own greedy choices plus one correction token. Sampled rows sample
        from the verify step's first-position logits (the plain-decode
        logits) with their own generator and ignore the proposals.

        Rejected positions' K/V (target and draft) stay behind as masked
        garbage: ``seq.length`` only advances over accepted tokens, and the
        next iteration's writes overwrite them before any mask reaches
        them."""
        running = [(i, r) for i, r in enumerate(self._slots)
                   if r is not None and r.state == "running"]
        if not running:
            return 0
        b, k = self.max_slots, self.spec_k
        tokens0 = np.zeros(b, np.int64)
        pos0 = np.zeros(b, np.int64)
        active = np.zeros(b, bool)
        for i, r in running:
            tokens0[i] = r.next_token
            pos0[i] = r.seq.length
            active[i] = True
        t_tables = self._tensor(self.cache.block_table_array(
            [r.seq if r is not None else None for r in self._slots],
            self.max_blocks_per_seq))
        d_tables = self._tensor(self.draft_cache.block_table_array(
            [r.draft_seq if r is not None else None for r in self._slots],
            self.max_blocks_per_seq))
        tokens0_t, pos0_t = self._tensor(tokens0), self._tensor(pos0)
        active_t = self._tensor(active)
        # 1) the draft proposes k tokens, greedy, writing its own cache, in
        # k+1 steps: step j consumes [pending, p1..pk][j], so the LAST step
        # only deposits p_k's K/V — without it a fully accepted window
        # would leave the draft's copy of the last accepted position
        # unwritten. The argmax stays on the device between the steps: a
        # host read per step would wait for every draft step in turn.
        d_tok, d_pos = tokens0_t, pos0_t
        prop_parts = []
        for j in range(k + 1):
            d_logits = decode_step(
                self.draft_params, d_tok, d_pos, self.draft_cache.k,
                self.draft_cache.v, d_tables, active_t, cfg=self.draft_cfg,
                impl=self.attn_impl)
            d_pos = d_pos + 1
            if j == k:
                break
            d_tok = torch.argmax(d_logits, dim=-1)
            prop_parts.append(d_tok)
        proposals_t = torch.stack(prop_parts, dim=1)                  # [B, k]
        # 2) the target verifies pending + proposals in one batched step
        logits = verify_step(
            self.params, torch.cat([tokens0_t[:, None], proposals_t], dim=1),
            pos0_t, self.cache.k, self.cache.v, t_tables, active_t, cfg=self.cfg)
        proposals = proposals_t.cpu().numpy()                         # [B, k]
        logits_np = logits.cpu().numpy()                              # [B, k+1, V]
        self._decode_steps += 1
        emitted = 0
        for i, r in running:
            r.seq.length += 1  # the pending token's K/V just landed
            sp = r.sampling
            done = len(r.out_tokens) >= sp.max_new_tokens or (
                sp.stop_token is not None
                and r.out_tokens and r.out_tokens[-1] == sp.stop_token)
            if done:
                self._finish(i, r)
                continue
            self._c_spec_proposed.inc(k)
            if sp.temperature > 0.0:
                # sampled rows take the plain-decode path off the verify
                # logits' first position
                cands = [sample_token(logits_np[i, 0], sp, r.rng)]
            else:
                greedy = np.argmax(logits_np[i], axis=-1)             # [k+1]
                m = 0
                while m < k and proposals[i, m] == greedy[m]:
                    m += 1
                self._c_spec_accepted.inc(m)
                cands = [int(t) for t in proposals[i, :m]] + [int(greedy[m])]
            finished = False
            for ci, tok in enumerate(cands):
                r.next_token = tok
                self._emit(r, tok)
                emitted += 1
                if len(r.out_tokens) >= sp.max_new_tokens or (
                        sp.stop_token is not None and tok == sp.stop_token):
                    self._finish(i, r)
                    finished = True
                    break
                if ci < len(cands) - 1:
                    # every accepted (non-final) token's K/V was verified
                    # into the cache this step; only the final emitted
                    # token stays pending
                    r.seq.length += 1
            if not finished:
                r.draft_seq.length = r.seq.length
        return emitted

    def _emit(self, req: GenRequest, tok: int) -> None:
        now = time.monotonic()
        req.out_tokens.append(tok)
        if req.first_token_at is None:
            req.first_token_at = now
            ttft = now - req.created_at
            self._h_ttft.observe(ttft)
            with self._obs_lock:
                self._ttft_obs.append(round(ttft, 6))
        else:
            itl = now - req.last_token_at
            self._h_itl.observe(itl)
            with self._obs_lock:
                self._itl_obs.append(round(itl, 6))
        req.last_token_at = now
        self._c_tokens.inc()
        req.stream.put(tok)

    def _note_done_locked(self, req: GenRequest) -> None:
        """Bound the completed-request cache: finished ids stay resumable
        until ``COMPLETED_CACHE`` newer completions push them out."""
        if not req.request_id:
            return
        if self._by_rid.get(req.request_id) is not req:
            return
        self._rid_done.append(req.request_id)
        while len(self._rid_done) > COMPLETED_CACHE:
            old = self._rid_done.popleft()
            stale = self._by_rid.get(old)
            if stale is not None and stale.state in ("done", "failed"):
                self._by_rid.pop(old, None)

    def _finish(self, slot: int, req: GenRequest) -> None:
        """Completion recycles blocks the same iteration — the freed slot
        admits a waiting request on the NEXT step, no global pause."""
        req.state = "done"
        req.finished_at = time.monotonic()
        self._release(req)
        self._slots[slot] = None
        self._c_requests.inc()
        req.stream.put(None)
        req.done.set()
        self._note_done_locked(req)

    def step(self) -> int:
        """One scheduling iteration; returns tokens emitted."""
        t0 = time.monotonic()
        with self._lock:
            self._expire_deadlines(t0)
            self._admit()
            self._maybe_preempt(t0)
            prefilled = self._prefill_one()
            emitted = self._decode_batch()
            self._admit()  # freed slots admit without waiting a full step
            if (self._waiting
                    or any(r is not None for r in self._slots)):
                self._work.set()
            if prefilled or emitted:
                # the engine pushed work through the model: readiness for
                # /healthz, and a step-time sample for the watchdog
                self._worked_steps += 1
                if self._worked_steps > 2:
                    self._step_durations.append(time.monotonic() - t0)
                self._ready.set()
        return emitted

    def step_p95_s(self) -> float:
        """p95 of recent working-step durations (0 while empty) — the
        watchdog's scaling input."""
        if not self._step_durations:
            return 0.0
        return float(np.percentile(np.asarray(self._step_durations), 95))

    def _beat_watchdog(self) -> None:
        # beats start once the engine is READY: before the first worked
        # step the watchdog's compile_grace_s applies (the first request
        # builds and warms the kernels), and an early beat would end that
        # window and read the build as a stall
        if self.watchdog is None:
            return
        if self._ready.is_set():
            self.watchdog.beat(self._decode_steps)
        else:
            # idle before any traffic: refresh the silence clock but keep
            # the build window open for the first request
            self.watchdog.touch()

    def _loop(self) -> None:
        while not self._stop.is_set():
            if not self._work.wait(timeout=0.5):
                self._beat_watchdog()  # idle is not a stall
                continue
            self._work.clear()
            try:
                self.step()
            except Exception as e:  # noqa: BLE001 — fail requests loudly
                traceback.print_exc()
                with self._lock:
                    for i, r in enumerate(self._slots):
                        if r is not None:
                            r.state = "failed"
                            r.error = repr(e)
                            r.finished_at = time.monotonic()
                            self._release(r)
                            self._slots[i] = None
                            r.stream.put(None)
                            r.done.set()
                            self._note_done_locked(r)
            if self.chaos is not None:
                # outside the scheduling lock: a wedged decode loop still
                # ACCEPTS requests (they pile into the bounded queue and
                # shed), as a device call that never returns would
                self.chaos.maybe_hang(int(self._c_requests.value))
            self._beat_watchdog()

    # -- traffic snapshot ------------------------------------------------------

    def snapshot(self) -> dict:
        """Cumulative counters + instantaneous gauges (the /stats body and
        the heartbeat's ``serve`` payload)."""
        elapsed = max(time.monotonic() - self._started_at, 1e-9)
        return {
            "running": self.running_count,
            "waiting": self.waiting_count,
            "kv_blocks_used": self.cache.allocator.used_count,
            "kv_blocks_total": self.cache.allocator.num_blocks,
            "requests_total": int(self._c_requests.value),
            "tokens_total": int(self._c_tokens.value),
            "decode_steps": self._decode_steps,
            "tokens_per_sec": self._c_tokens.value / elapsed,
            "ttft_p50_ms": _ms(self._h_ttft.quantile(0.50)),
            "ttft_p95_ms": _ms(self._h_ttft.quantile(0.95)),
            "intertoken_p50_ms": _ms(self._h_itl.quantile(0.50)),
            "intertoken_p95_ms": _ms(self._h_itl.quantile(0.95)),
            "rejected_total": int(self._c_rejected.value),
            "preemptions_total": int(self._c_preempted.value),
            "prefix_cache_hits": int(self._c_prefix_hits.value),
            "prefix_cache_misses": int(self._c_prefix_misses.value),
            "shared_kv_blocks": int(self.cache.allocator.shared_count),
            "cow_copies": int(self._c_cow.value),
            "spec_tokens_proposed": int(self._c_spec_proposed.value),
            "spec_tokens_accepted": int(self._c_spec_accepted.value),
            "kv_audit_violations": int(
                self.cache.allocator.audit_violations + (
                    self.draft_cache.allocator.audit_violations
                    if self.draft_cache is not None else 0)),
            "draining": bool(self._draining),
            "drained": bool(self.drained) if self._draining else False,
            "ready": self.ready,
        }

    def drain_observations(self, max_each: int = 256) -> dict:
        """Raw TTFT / inter-token samples since the last drain (bounded):
        the heartbeat ships them so the control plane's histograms observe
        real values, not a lossy re-aggregation."""
        with self._obs_lock:
            ttft = [self._ttft_obs.popleft()
                    for _ in range(min(max_each, len(self._ttft_obs)))]
            itl = [self._itl_obs.popleft()
                   for _ in range(min(max_each, len(self._itl_obs)))]
        return {"ttft": ttft, "itl": itl}


def params_device(params: dict) -> torch.device:
    """The one device every leaf of ``params`` lives on; raises when the
    leaves are spread over several."""
    devices = set()

    def visit(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                visit(v)
        else:
            devices.add(tree.device)

    visit(params)
    if len(devices) != 1:
        raise ValueError(f"params must live on one device, found "
                         f"{sorted(map(str, devices))}")
    return devices.pop()


def _ms(v: Optional[float]) -> Optional[float]:
    return None if v is None else round(v * 1e3, 3)
