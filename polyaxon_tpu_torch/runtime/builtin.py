"""Built-in training entry of the port — counterpart of
``polyaxon_tpu/runtime/builtin.py``, for every family of the port's model
zoo: causal LMs, BERT MLM, ViT and ResNet, on one process or on one
process per GPU.

    PLX_BUILTIN_SPEC='{"model": "llama-tiny", "platform": "cpu",
                       "steps": 5}' \\
        python -m polyaxon_tpu_torch.runtime.builtin

A multi-process run starts from the rendezvous env the compiler gives
every pod of a distributed run (``PLX_COORDINATOR_ADDRESS``,
``PLX_NUM_PROCESSES``, ``PLX_PROCESS_ID``) or from ``torchrun``'s: the
process joins the group (NCCL on ``cuda:LOCAL_RANK``, gloo with
``platform: cpu``) before it touches a device, trains its share of the
mesh (``parallelism``; unspecified capacity goes to ``data``), and rank 0
alone tracks, prints the ``{"step"}`` and ``{"final"}`` lines, writes
``final.json`` and the checkpoints.

Spec keys (the JAX runtime's, as far as the port goes):
    model (a name of the registry), steps, batch_size, learning_rate,
    warmup_steps, schedule, optimizer (adamw | sgd | lion | adafactor),
    mu_dtype / nu_dtype / grad_dtype / accum_dtype, microbatches,
    data {kind (synthetic-lm | synthetic-mlm | synthetic-image |
    tokens-file; the task's own by default), path, seed}, log_interval,
    anomaly_skip_budget, anomaly_rollback_budget, watchdog (true, false or
    {stall_factor, min_s, compile_grace_s}), parallelism ({data, fsdp,
    model, context, stage, expert}: model and stage for the transformer
    families, context for the language models and ViT, ring or Ulysses as
    the model config's ``seq_parallel`` says, expert a batch axis that also
    cuts an MoE model's experts; ResNet's compute is replicated over model
    and context), num_slices (else
    ``$MEGASCALE_NUM_SLICES``, else 1: the slices split the ranks in order
    and must divide data x fsdp).
    Language models (lm, mlm) also take seq_len, remat, attn_block_q /
    attn_block_k / attn_block_q_bwd / attn_block_k_bwd,
    loss_chunk_tokens, the pipeline's pp_microbatches (0: 2 x stages),
    pp_remat_ticks and pp_gate (auto | full | inner | none), and an MoE
    model's moe_dispatch (capacity | a2a | dense) and moe_cap_block;
    ResNet takes image_size (32 or 224 by the config's ``small_inputs``).
    ViT's sequence (patches + CLS) and image size are its config's.
    checkpoint: on by default, under ``$PLX_ARTIFACTS_PATH/outputs/
        checkpoints`` (the working directory without it): false, or
        {save_interval_steps (steps // 4), max_to_keep (3), async_save
        (true)}. A restarted run resumes from its newest complete step.
    import: {path, layout (flat | hf-llama | auto), dtype, key_map,
        transpose} — start from a foreign checkpoint (language models
        only); a complete checkpoint of the run itself wins (resume beats
        re-import). With ``lora:`` the imported tree is the frozen base,
        beside fresh adapters drawn from ``seed`` (0).
    lora: {rank, alpha, target, init_scale} or true — train low-rank
        adapters over a frozen base (language models only): the params are
        ``{base, lora}``, the optimizer keeps moments for the adapters
        alone and clips them by their own norm; ``grad_norm`` covers both.
    partition_rules: [[regex, spec], ...] laid over the model's built-in
        specs (``polyaxon_tpu_torch.partition``): the storage of the params,
        grads and optimizer state. A leaf whose rule moves, drops or adds a
        cut on model, stage or (all-to-all) expert is read as the built-in
        spec cuts it, resharded where it is read.
    fork_from: {path, step?} — start from another run's checkpoint,
        restored read-only (a torn pinned step falls back to the parent's
        newest complete one); resume beats re-fork too.
    platform: "cuda" (the default; raises without a CUDA device) or "cpu",
    which must be asked for.
    progress_interval: seconds between progress heartbeats (default 2).
    chaos: {hang_at_step, nan_at_step, nan_count, straggler_at_step,
        straggler_sleep_s, hang_sleep_s} — trainer fault injection, its
        budgets kept in the artifacts directory across attempts.
    resources: host and GPU memory telemetry into the run's events every
        10 s (the default, true); false disables, {interval: N} tunes.
    profile: true or {steps: N} (3) — after the measured steps, trace the
        last N steps with ``torch.profiler`` into ``outputs/profile`` as a
        Chrome trace. The summary's meter keys read the steps before the
        profiler: once it has run, every launch in the process costs more
        host time.

The ``lora:``, ``import:`` and ``partition_rules:`` blocks are validated
(``partition.validate_builtin_spec``, the JAX compiler's check) before any
device work. Every other key raises: a key is never ignored.

Tracking. When the control plane launched the process (``PLX_RUN_UUID``,
``PLX_ARTIFACTS_PATH`` or ``PLX_API_HOST`` is set), the primary process
owns a tracked run (``polyaxon_tpu_torch.tracking``), as the JAX runtime
does: the logged steps' metrics go to its events and the meter keys to its
outputs, spans mark the first step, the train window, saves, rollbacks and
a stall, progress heartbeats carry the step, and the end sends the summary
as outputs with the ``checkpoints`` artifact. Before the first step the
run's outputs get ``partition_plan``: the param count, bytes, bytes per
device and axes used of the trainer's resolved specs, with ``num_slices``. The run also reports its own
``running`` and ``succeeded`` statuses (the JAX runtime leaves both to the
agent; under an agent they are no-change edges). Each logged step also prints
a ``{"step": ...}`` line, and the summary prints as ``{"final": {...}}``
and, when ``PLX_ARTIFACTS_PATH`` is set, lands in ``outputs/final.json``
there.
"""

from __future__ import annotations

import functools
import json
import os
import time
from dataclasses import replace
from typing import Any, Callable, Optional

import torch

from .. import parallel
from ..parallel.mesh import build_mesh, normalize_axis_sizes
from ..train.checkpoint import CheckpointConfig
from ..train.optimizers import OPTIMIZERS

#: the values the JAX package's model code takes (it raises on others)
_MOE_DISPATCHES = ("capacity", "a2a", "dense")
_PP_GATES = ("auto", "full", "inner", "none")
#: the JAX runtime's virtual CPU devices: the port's counterpart is ranks
NUM_CPU_DEVICES_REFUSAL = (
    "num_cpu_devices: the port has no virtual CPU devices; its CPU counterpart of "
    "an N-device mesh is N gloo ranks, one process each (PLX_NUM_PROCESSES=N with "
    "platform: cpu), as its tests launch them")

_KNOWN = {
    "model", "steps", "batch_size", "seq_len", "learning_rate", "warmup_steps",
    "schedule", "optimizer", "remat", "attn_block_q", "attn_block_k",
    "attn_block_q_bwd", "attn_block_k_bwd", "loss_chunk_tokens", "mu_dtype",
    "nu_dtype", "grad_dtype", "accum_dtype", "microbatches", "data", "log_interval",
    "anomaly_skip_budget", "anomaly_rollback_budget", "watchdog", "parallelism",
    "num_slices", "checkpoint", "import", "fork_from", "platform",
    "progress_interval", "chaos", "resources", "profile", "image_size",
    "pp_microbatches", "pp_remat_ticks", "pp_gate", "moe_dispatch", "moe_cap_block",
    "lora", "partition_rules", "seed",
}
#: keys only a language model (family lm or mlm) reads
_LM_KEYS = {"seq_len", "remat", "attn_block_q", "attn_block_k", "attn_block_q_bwd",
            "attn_block_k_bwd", "loss_chunk_tokens", "pp_microbatches", "pp_remat_ticks",
            "pp_gate", "moe_dispatch", "moe_cap_block"}
_DATA_KEYS = {"kind", "path", "seed"}
_DATA_KINDS = ("synthetic-lm", "synthetic-mlm", "synthetic-image", "tokens-file")
_CHECKPOINT_KEYS = {"save_interval_steps", "max_to_keep", "async_save"}
_IMPORT_KEYS = {"path", "layout", "dtype", "key_map", "transpose"}
_FORK_KEYS = {"path", "step"}
_CHAOS_KEYS = {"hang_at_step", "nan_at_step", "nan_count", "straggler_at_step",
               "straggler_sleep_s", "hang_sleep_s"}
#: the meter's keys, which every tracked interval also sends as run outputs
METER_KEYS = ("steps", "step_time_ms", "step_time_p50_ms", "step_time_p95_ms",
              "tokens_per_sec", "tokens_per_sec_per_chip", "achieved_tflops_per_chip",
              "mfu")


def _refuse_unsupported(spec: dict) -> None:
    """Raise on every key or value the port does not support."""
    for key, value in spec.items():
        if key == "num_cpu_devices":
            raise SystemExit(NUM_CPU_DEVICES_REFUSAL)
        if key not in _KNOWN:
            raise SystemExit(f"unknown spec key {key!r} for the port's builtin runtime")
    for key, allowed in (("checkpoint", _CHECKPOINT_KEYS), ("import", _IMPORT_KEYS),
                         ("fork_from", _FORK_KEYS), ("chaos", _CHAOS_KEYS),
                         ("resources", {"interval"}), ("profile", {"steps"})):
        value = spec.get(key)
        if isinstance(value, dict):
            unknown = set(value) - allowed
            if unknown:
                raise SystemExit(f"{key}: unknown keys {sorted(unknown)}; "
                                 f"valid: {sorted(allowed)}")
        elif key in ("import", "fork_from") and value is not None:
            raise SystemExit(f"{key}: needs a mapping with a path, got {value!r}")
        elif key == "chaos" and value is not None:
            raise SystemExit(f"chaos: needs a mapping, got {value!r}")
    for key in ("import", "fork_from"):
        if spec.get(key) is not None and not spec[key].get("path"):
            raise SystemExit(f"{key}: needs a path")
    if spec.get("moe_dispatch") and spec["moe_dispatch"] not in _MOE_DISPATCHES:
        raise SystemExit(f"unknown moe_dispatch {spec['moe_dispatch']!r}; "
                         f"valid: {'|'.join(_MOE_DISPATCHES)}")
    if spec.get("pp_gate") and spec["pp_gate"] not in _PP_GATES:
        raise SystemExit(f"unknown gate mode {spec['pp_gate']!r}; "
                         f"valid: {'|'.join(_PP_GATES)}")
    if spec.get("optimizer", "adamw") not in OPTIMIZERS:
        raise SystemExit(f"optimizer {spec['optimizer']!r}: unknown; valid: "
                         f"{'|'.join(OPTIMIZERS)}")
    from ..models import REGISTRY
    from ..train.tasks import refuse_unsupported_axes

    family, model = REGISTRY.get(spec.get("model", "llama-tiny"), (None, None))
    if family not in (None, "lm", "mlm"):
        # the JAX runtime's words, before the validation's
        if spec.get("lora"):
            raise SystemExit(f"lora: is only supported for LM/MLM models (got {family})")
        if spec.get("import") is not None:
            raise SystemExit(f"import: is only supported for LM/MLM models "
                             f"(got {spec.get('model')!r})")
    if spec.get("moe_dispatch") and getattr(model, "num_experts", 0):
        model = replace(model, moe_dispatch=spec["moe_dispatch"])
    try:
        refuse_unsupported_axes(model, normalize_axis_sizes(spec.get("parallelism")))
    except (ValueError, NotImplementedError) as e:
        raise SystemExit(f"parallelism {spec.get('parallelism')}: {e}") from e
    if family is not None:
        from ..partition import needs_validation, validate_builtin_spec

        if needs_validation(spec):
            try:
                validate_builtin_spec(spec)
            except ValueError as e:  # RuleSyntaxError, LoRATargetError
                raise SystemExit(f"{type(e).__name__}: {e}") from e
    data = dict(spec.get("data") or {})
    unknown = set(data) - _DATA_KEYS
    if unknown:
        raise SystemExit(f"data: unknown keys {sorted(unknown)}; valid: {sorted(_DATA_KEYS)}")
    if data.get("kind") is not None and data["kind"] not in _DATA_KINDS:
        raise SystemExit(f"data kind {data['kind']!r}: unknown; valid: {'|'.join(_DATA_KINDS)}")
    if data.get("kind") == "tokens-file" and not data.get("path"):
        raise SystemExit("data kind tokens-file needs a path")


def _refuse_family_keys(spec: dict, family: str) -> None:
    """Raise on a key that the model's family does not read."""
    if family not in ("lm", "mlm"):
        keys = sorted(_LM_KEYS & set(spec))
        if keys:
            raise SystemExit(f"{keys}: only language models take them; {family} "
                             f"models do not")
    if family != "resnet" and "image_size" in spec:
        raise SystemExit(f"image_size: only resnet models take it ({family} models do "
                         f"not; a vit's is its config's)")


def resolve_device(spec: dict) -> torch.device:
    """CUDA by default (raises without a device): this process's GPU,
    ``cuda:LOCAL_RANK`` in a multi-process run; the CPU only when asked."""
    platform = spec.get("platform") or "cuda"
    if platform == "cpu":
        return torch.device("cpu")
    if platform == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("platform 'cuda' needs a usable CUDA device and none is "
                               "available; pass platform: cpu to train on the CPU")
        if parallel.process_info_from_env().is_distributed:
            return torch.device("cuda", parallel.local_rank())
        return torch.device("cuda", torch.cuda.current_device())
    raise ValueError(f"unknown platform {platform!r}; valid: cuda|cpu")


def _accelerator(device: torch.device) -> Optional[str]:
    """The meter's peak-table entry for the device (None: no MFU)."""
    if device.type == "cuda" and "H100" in torch.cuda.get_device_name(device):
        return "h100"
    return None


def build_trainer(spec: dict[str, Any],
                  track: Optional[Callable[[int, dict], None]] = None,
                  bridge: Optional["TrackingBridge"] = None,
                  artifacts_dir: Optional[str] = None):
    """The spec's Trainer and its data stream (at batch 0), as
    :func:`run_builtin` trains them; raises on every key the port does not
    support. ``bridge`` hooks a tracked run into the trainer;
    ``artifacts_dir`` (default ``$PLX_ARTIFACTS_PATH``, else the working
    directory) holds the checkpoints and the chaos budgets."""
    from ..models import REGISTRY
    from ..train import (
        DataConfig, OptimizerConfig, Trainer, TrainerConfig, make_batches, task_for,
    )
    from ..train import data as data_mod

    _refuse_unsupported(spec)
    name = spec.get("model", "llama-tiny")
    if name not in REGISTRY:
        raise SystemExit(f"Unknown model {name!r}; available: {sorted(REGISTRY)}")
    family, mcfg = REGISTRY[name]
    _refuse_family_keys(spec, family)
    device = resolve_device(spec)

    data_kwargs: dict[str, Any] = {}
    if family in ("lm", "mlm"):
        overrides: dict[str, Any] = {}
        if spec.get("remat"):
            overrides["remat"] = spec["remat"]
        if spec.get("loss_chunk_tokens") is not None:
            overrides["loss_chunk_tokens"] = int(spec["loss_chunk_tokens"])
        for knob in ("attn_block_q", "attn_block_k", "attn_block_q_bwd",
                     "attn_block_k_bwd", "moe_cap_block", "pp_microbatches"):
            if spec.get(knob) is not None:
                overrides[knob] = int(spec[knob])
        if spec.get("moe_dispatch"):
            overrides["moe_dispatch"] = spec["moe_dispatch"]
        if spec.get("pp_gate"):
            overrides["pp_gate"] = spec["pp_gate"]
        if spec.get("pp_remat_ticks") is not None:
            overrides["pp_remat_ticks"] = bool(spec["pp_remat_ticks"])
        seq_len = int(spec.get("seq_len", min(2048, mcfg.max_seq)))
        if seq_len > mcfg.max_seq:
            overrides["max_seq"] = seq_len
        if overrides:
            mcfg = replace(mcfg, **overrides)
        task = task_for(family, mcfg)
        data_kwargs["vocab_size"] = mcfg.vocab_size
    elif family == "vit":
        seq_len = mcfg.num_patches + 1
        task = task_for(family, mcfg)
        data_kwargs.update(image_size=mcfg.image_size, num_classes=mcfg.num_classes)
    elif family == "resnet":
        image_size = int(spec.get("image_size", 32 if mcfg.small_inputs else 224))
        seq_len = 1
        task = task_for(family, mcfg, image_size=image_size)
        data_kwargs.update(image_size=image_size, num_classes=mcfg.num_classes)
    else:
        raise SystemExit(f"no builtin task for model family {family!r} in the port")

    steps = int(spec.get("steps", 100))
    batch_size = int(spec.get("batch_size", 8))
    if artifacts_dir is None:
        artifacts_dir = os.environ.get("PLX_ARTIFACTS_PATH", os.getcwd())
    ckpt_spec = spec.get("checkpoint")
    ckpt_kw = ckpt_spec if isinstance(ckpt_spec, dict) else {}
    ckpt = CheckpointConfig(
        directory=os.path.join(artifacts_dir, "outputs", "checkpoints"),
        save_interval_steps=int(ckpt_kw.get("save_interval_steps", max(steps // 4, 1))),
        max_to_keep=int(ckpt_kw.get("max_to_keep", 3)),
        async_save=bool(ckpt_kw.get("async_save", True)),
    ) if ckpt_spec is not False else None
    wd_spec = spec.get("watchdog", True)
    wd_kw = wd_spec if isinstance(wd_spec, dict) else {}
    tcfg = TrainerConfig(
        model=mcfg,
        optimizer=OptimizerConfig(
            name=spec.get("optimizer", "adamw"),
            learning_rate=float(spec.get("learning_rate", 3e-4)),
            warmup_steps=int(spec.get("warmup_steps", min(100, steps // 10 + 1))),
            total_steps=steps,
            schedule=spec.get("schedule", "cosine"),
            mu_dtype=spec.get("mu_dtype"),
            nu_dtype=spec.get("nu_dtype"),
        ),
        batch_size=batch_size,
        seq_len=seq_len,
        parallelism=spec.get("parallelism"),
        num_slices=num_slices(spec),
        checkpoint=ckpt,
        log_interval=int(spec.get("log_interval", 10)),
        accelerator=_accelerator(device),
        grad_dtype=spec.get("grad_dtype"),
        microbatches=int(spec.get("microbatches", 1)),
        accum_dtype=spec.get("accum_dtype"),
        anomaly_skip_budget=int(spec.get("anomaly_skip_budget", 3)),
        anomaly_rollback_budget=int(spec.get("anomaly_rollback_budget", 2)),
        watchdog=wd_spec is not False,
        watchdog_stall_factor=float(wd_kw.get("stall_factor", 10.0)),
        watchdog_min_s=float(wd_kw.get("min_s", 120.0)),
        watchdog_compile_grace_s=float(wd_kw.get("compile_grace_s", 1800.0)),
    )

    primary = _is_primary()

    def _track(step: int, metrics: dict) -> None:
        if primary:
            print(json.dumps({"step": step, **metrics}), flush=True)
        if bridge is not None:
            bridge.track(step, metrics)
        if track is not None:
            track(step, metrics)

    from ..resilience.chaos import TrainerChaos

    hooks = {} if bridge is None else dict(
        on_span=bridge.on_span, on_progress=bridge.on_progress,
        on_stalled=bridge.on_stalled, log_line=bridge.log_line)
    try:
        mesh = build_mesh(tcfg.parallelism, num_slices=tcfg.num_slices)
    except ValueError as e:  # a mesh larger than the process group
        raise SystemExit(f"parallelism {tcfg.parallelism}: {e}") from e
    tx = None
    if spec.get("lora"):
        # a frozen base and trainable adapters; the optimizer sees the
        # adapters alone (their moments, their norm for the clip)
        from ..partition.lora import FrozenBaseOptimizer, LoRAConfig, LoRATask
        from ..train.optimizers import make_optimizer

        task = LoRATask(task, LoRAConfig.from_spec(spec["lora"]))
        tx = FrozenBaseOptimizer(make_optimizer(tcfg.optimizer))
    trainer = Trainer(tcfg, device=device, mesh=mesh, task=task, track=_track,
                      chaos=TrainerChaos.from_spec(spec.get("chaos"), state_dir=artifacts_dir),
                      partition_rules=spec.get("partition_rules"), tx=tx, **hooks)
    data_spec = dict(spec.get("data") or {})
    rows = cols = None
    if trainer.mesh.distributed:
        rows = data_mod.local_rows(batch_size, tcfg.microbatches, trainer.batch_index,
                                   trainer.batch_ranks)
    if trainer.mesh.distributed and family in ("lm", "mlm"):
        # a vision batch is whole on every context rank: ViT cuts its
        # tokens itself, ResNet replicates its compute
        try:
            cols = data_mod.local_cols(batch_size, seq_len, trainer.mesh.seq_index,
                                       trainer.mesh.cp)
        except ValueError as e:
            raise SystemExit(f"parallelism {tcfg.parallelism}: {e}") from e
    batches = make_batches(DataConfig(
        kind=data_spec.get("kind") or task.default_data_kind, batch_size=batch_size,
        seq_len=seq_len, path=data_spec.get("path"), seed=int(data_spec.get("seed", 0)),
        rows=rows, cols=cols, **data_kwargs))
    return trainer, batches


def num_slices(spec: dict) -> int:
    """The spec's ``num_slices``, else ``$MEGASCALE_NUM_SLICES`` (set for
    every pod of a multislice job), else 1."""
    return int(spec.get("num_slices", os.environ.get("MEGASCALE_NUM_SLICES", 1)))


def partition_plan(trainer) -> dict:
    """The run output ``partition_plan``: the summary of the trainer's
    resolved specs over its mesh, with the slice count."""
    from ..partition import plan_summary_from_shardings

    summary = plan_summary_from_shardings(trainer.task.abstract_params(), trainer.specs,
                                          trainer.mesh)
    summary["num_slices"] = trainer.cfg.num_slices
    return summary


def _timed(method):
    """Add the host time spent inside ``method`` to the bridge's ``host_s``."""
    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return method(self, *args, **kwargs)
        finally:
            self.host_s += time.perf_counter() - t0
    return wrapper


class TrackingBridge:
    """The trainer's hooks into a tracked run, as the JAX runtime wires
    them: each logged step's metrics into the run's events and the meter
    keys into its outputs, spans, rate-limited progress heartbeats, and a
    ``TrainingStalled`` status before the watchdog's hard exit. ``host_s``
    is the host time spent inside these callbacks (the bridge's cost)."""

    def __init__(self, run, progress_interval: float = 2.0):
        self.run = run
        self.progress_interval = float(progress_interval)
        self._last_beat = float("-inf")
        self.host_s = 0.0

    @_timed
    def track(self, step: int, metrics: dict) -> None:
        self.run.log_metrics(step=step, **{
            k: v for k, v in metrics.items() if isinstance(v, (int, float))})
        self.run.log_outputs(**{k: metrics[k] for k in METER_KEYS if k in metrics})

    @_timed
    def on_span(self, name: str, start: float, end: float, **meta: Any) -> None:
        self.run.log_span(name, start, end, **meta)

    @_timed
    def on_progress(self, step: int, anomalies: dict, rollbacks: int) -> None:
        now = time.monotonic()
        if now - self._last_beat < self.progress_interval:
            return
        self._last_beat = now
        self.run.report_progress(step, anomalies=dict(anomalies), rollbacks=rollbacks)

    def on_stalled(self, step: int, waited: float, limit: float) -> None:
        # a structured status and a durable flush: the watchdog hard-exits
        # right after this, and the epitaph must survive the process
        self.run.log_status(
            "running", reason="TrainingStalled",
            message=f"no step completed for {waited:.1f}s (limit {limit:.1f}s, "
                    f"last step {step}); watchdog hard-exit -> retry budget")
        self.run.flush()

    @_timed
    def log_line(self, line: str) -> None:
        self.run.log_line(line)
        print(line, flush=True)


def _is_primary() -> bool:
    """Rank 0 of a process group, or the only process."""
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def _tracked_run():
    """The process's tracked run when the control plane launched it and
    this is the primary process, else None (a library call with no PLX_*
    environment writes no run directory)."""
    from .. import tracking
    from ..tracking.run import ENV_API_HOST, ENV_ARTIFACTS_PATH, ENV_RUN_UUID

    launched = any(os.environ.get(k) for k in (ENV_RUN_UUID, ENV_ARTIFACTS_PATH,
                                               ENV_API_HOST))
    return tracking.get_run() if launched and _is_primary() else None


def run_builtin(spec: dict[str, Any],
                track: Optional[Callable[[int, dict], None]] = None) -> dict[str, Any]:
    """Train ``spec['model']`` for ``spec['steps']`` steps and return the
    summary (every rank's, in a multi-process run). ``track(step,
    metrics)``, when given, also receives each logged step's metrics.
    The process joins the env's process group first (a no-op for one
    process, or when the caller made the group) and leaves a group it
    joined at the end."""
    _refuse_unsupported(spec)  # before a run directory or a device is touched
    joined = not torch.distributed.is_initialized()
    parallel.initialize(device=resolve_device(spec))
    joined = joined and torch.distributed.is_initialized()
    try:
        run = _tracked_run()
        try:
            return _run_builtin(spec, track, run)
        except BaseException:
            if run is not None:
                run.end()  # flush and close the writers of a failed attempt
            raise
    finally:
        if joined:
            parallel.shutdown()


def _run_builtin(spec: dict, track, run) -> dict[str, Any]:
    from ..train.data import skip_batches
    from ..train.trainer import TrainingDivergedError

    artifacts_dir = (run.run_dir if run is not None
                     else os.environ.get("PLX_ARTIFACTS_PATH", os.getcwd()))
    bridge = None
    if run is not None:
        # a leftover progress.json describes a dead attempt
        try:
            os.unlink(os.path.join(artifacts_dir, run.PROGRESS_FILE))
        except OSError:
            pass
        bridge = TrackingBridge(run, float(spec.get("progress_interval", 2.0)))
    trainer, batches = build_trainer(spec, track, bridge=bridge,
                                     artifacts_dir=artifacts_dir)
    if run is not None:
        # the pod reports its own lifecycle edges; under an agent they are
        # no-change edges the control plane answers 200 to
        run.log_status("running", reason="Training",
                       message=f"{spec.get('model', 'llama-tiny')} on {trainer.device}")
        run.log_outputs(partition_plan=partition_plan(trainer))
    device, steps = trainer.device, trainer.cfg.optimizer.total_steps
    t_restore = time.time()
    init_params, init_extra = _initial_params(spec, trainer, trainer.cfg.model, device)
    state, start_step = trainer.restore_or_init(init_params=init_params,
                                                init_extra=init_extra)
    if run is not None:
        run.log_span("restore", t_restore, time.time(), resumed_from_step=int(start_step))
    # a resumed run continues the data stream where the checkpoint left it
    skip_batches(batches, start_step)
    res_spec = spec.get("resources", True)
    res_logger = None
    if run is not None and res_spec is not False:
        from ..tracking import ResourceLogger

        interval = float(res_spec.get("interval", 10.0)) if isinstance(res_spec, dict) else 10.0
        res_logger = ResourceLogger(run, interval=interval).start()
    try:
        metrics = _fit(spec, trainer, batches, state, steps, artifacts_dir, run)
    except TrainingDivergedError as e:
        if run is not None:
            run.log_outputs(
                diverged=True,
                train_anomalies_loss=int(e.anomalies.get("loss", 0)),
                train_anomalies_grad=int(e.anomalies.get("grad", 0)),
                train_rollbacks=int(e.rollbacks), anomaly_history=e.history,
                resumed_from_step=int(start_step))
            run.log_status("failed", reason="TrainingDiverged", message=str(e))
        raise SystemExit(f"training diverged: {e}") from e
    finally:
        if res_logger is not None:
            res_logger.stop()
    summary = {k: v for k, v in metrics.items() if isinstance(v, (int, float)) or v is None}
    summary["resumed_from_step"] = int(start_step)
    summary["device"] = (torch.cuda.get_device_name(device) if device.type == "cuda"
                         else "cpu")
    summary["processes"] = trainer.mesh.size
    if run is not None:
        summary["bridge_host_s"] = bridge.host_s
        # the final beat lands the store's heartbeat step on the last step
        run.report_progress(
            steps, anomalies={"loss": summary.get("train_anomalies_loss", 0),
                              "grad": summary.get("train_anomalies_grad", 0)},
            rollbacks=int(summary.get("train_rollbacks", 0)))
        run.log_outputs(**summary)
        if trainer.checkpointer is not None:
            run.log_artifact("checkpoints", "outputs/checkpoints", kind="checkpoint")
    artifacts = os.environ.get("PLX_ARTIFACTS_PATH")
    if artifacts and trainer.primary:
        out_dir = os.path.join(artifacts, "outputs")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "final.json"), "w") as f:
            json.dump(summary, f)
    if trainer.primary:
        print(json.dumps({"final": summary}), flush=True)
    if run is not None:
        # last: once the control plane reads `succeeded` it may reap the pod
        run.end(status="succeeded")
    return summary


def _fit(spec: dict, trainer, batches, state, steps: int, artifacts_dir: str,
         run) -> dict:
    """Train to ``steps``; with ``profile``, trace the last N steps with
    ``torch.profiler`` into ``outputs/profile``. The meter keys of the
    result read the steps before the profiler (its CUPTI tracing slows
    every later launch); the loss and the anomaly counts cover all."""
    profile = spec.get("profile")
    if not profile:
        return trainer.fit(batches, num_steps=steps, state=state)[1]
    prof_steps = int(profile.get("steps", 3)) if isinstance(profile, dict) else 3
    split = max(steps - prof_steps, int(state.step))
    measured = None
    if split > state.step:
        state, measured = trainer.fit(batches, num_steps=split, state=state)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if trainer.device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof_dir = os.path.join(artifacts_dir, "outputs", "profile")
    with torch.profiler.profile(activities=activities) as prof:
        state, profiled = trainer.fit(batches, num_steps=steps, state=state)
    if trainer.primary:  # rank 0's trace stands for the run
        os.makedirs(prof_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(prof_dir, "trace.json"))
    if run is not None:
        run.log_artifact("profile", "outputs/profile", kind="profile")
    if measured is None:
        return profiled
    merged = {**profiled, **{k: measured[k] for k in METER_KEYS}}
    for k in ("train_anomalies_loss", "train_anomalies_grad", "train_rollbacks"):
        merged[k] = measured[k] + profiled[k]
    return merged


def _initial_params(spec: dict, trainer, mcfg, device) -> tuple[Optional[dict], Any]:
    """(this rank's blocks of the params, extra) to start from instead of
    a fresh init: ``import:`` (a foreign checkpoint, read by block under
    the trainer's layout; no extra) or ``fork_from:`` (another run's
    checkpoint, read-only: this rank's blocks of its params, with its
    extra: ResNet's batch statistics). (None, None) when neither is asked
    for, or when the run has a complete checkpoint of its own — resume
    beats re-import and re-fork."""
    import_spec, fork_spec = spec.get("import"), spec.get("fork_from")
    if not (import_spec or fork_spec):
        return None, None
    if trainer.checkpointer is not None and trainer.latest_complete_step() is not None:
        print("[builtin] complete checkpoint found; skipping "
              f"{'import' if import_spec else 'fork restore'}", flush=True)
        return None, None
    params = extra = None
    if import_spec:
        from ..partition import convert as pconvert
        from ..train.tasks import LMTask

        if not isinstance(getattr(trainer.task, "inner", trainer.task), LMTask):
            raise SystemExit(f"import: is only supported for LM/MLM models "
                             f"(got {spec.get('model')!r})")
        lora = spec.get("lora")
        place = trainer.placement()
        params = pconvert.import_params(
            import_spec["path"], mcfg, device=device,
            layout=import_spec.get("layout", "auto"),
            dtype=import_spec.get("dtype"),
            key_map=import_spec.get("key_map"),
            transpose=import_spec.get("transpose"),
            placement=place.under("base") if lora else place)
        if lora:
            # the imported tree is the frozen base, beside fresh adapters:
            # this rank's blocks of their laws, as a fresh init builds them
            from ..parallel.blocks import init_tree

            params = {"base": params, "lora": init_tree(
                trainer.task.param_laws()["lora"], int(spec.get("seed", 0)), device,
                place, "lora/")}
    if fork_spec:
        from ..train.checkpoint import Checkpointer

        ro = Checkpointer(CheckpointConfig(directory=fork_spec["path"]), read_only=True)
        fork_step = fork_spec.get("step")
        # this rank's blocks of the parent's params; its extra whole
        place = trainer.placement().prefixed("params")
        try:
            raw, restored = ro.restore_raw(
                step=int(fork_step) if fork_step is not None else None,
                device=device, placement=place, keys=("params", "extra"))
        except Exception as e:
            if fork_step is None:
                raise
            # the pinned step tore with the parent's preemption: fall back
            # to the parent's newest complete step
            raw, restored = ro.restore_raw(device=device, placement=place,
                                           keys=("params", "extra"))
            print(f"[builtin] fork step {fork_step} not restorable ({e}); "
                  f"using parent step {restored}", flush=True)
        params, extra = raw["params"], raw.get("extra")
        print(f"[builtin] forked from {fork_spec['path']} @ step {restored}",
              flush=True)
    return params, extra


def main() -> None:
    raw = os.environ.get("PLX_BUILTIN_SPEC")
    if not raw:
        raise SystemExit("PLX_BUILTIN_SPEC not set")
    run_builtin(json.loads(raw))


if __name__ == "__main__":
    main()
