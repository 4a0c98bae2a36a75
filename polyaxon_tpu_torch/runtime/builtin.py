"""Built-in training entry of the port — counterpart of
``polyaxon_tpu/runtime/builtin.py`` for dense causal LMs on one device.

    PLX_BUILTIN_SPEC='{"model": "llama-tiny", "platform": "cpu",
                       "steps": 5}' \\
        python -m polyaxon_tpu_torch.runtime.builtin

Spec keys (the JAX runtime's, as far as the port goes):
    model (a dense LM of the registry), steps, batch_size, seq_len,
    learning_rate, warmup_steps, schedule, optimizer ("adamw"), remat,
    attn_block_q / attn_block_k / attn_block_q_bwd / attn_block_k_bwd,
    loss_chunk_tokens, mu_dtype / nu_dtype / grad_dtype / accum_dtype,
    microbatches, data {kind: synthetic-lm, seed}, log_interval,
    anomaly_skip_budget, anomaly_rollback_budget, watchdog (true, false or
    {stall_factor, min_s, compile_grace_s}), parallelism ({data: 1}),
    num_slices (1).
    checkpoint: on by default, under ``$PLX_ARTIFACTS_PATH/outputs/
        checkpoints`` (the working directory without it): false, or
        {save_interval_steps (steps // 4), max_to_keep (3), async_save
        (true)}. A restarted run resumes from its newest complete step.
    import: {path, layout (flat | hf-llama | auto), dtype, key_map,
        transpose} — start from a foreign checkpoint; a complete
        checkpoint of the run itself wins (resume beats re-import).
    fork_from: {path, step?} — start from another run's checkpoint,
        restored read-only (a torn pinned step falls back to the parent's
        newest complete one); resume beats re-fork too.
    platform: "cuda" (the default; raises without a CUDA device) or "cpu",
    which must be asked for.

Every other key raises, naming the ROADMAP item that ports it: a key is
never ignored. The tracking bridge (run metrics, spans, outputs) waits for
ROADMAP A5; until then each logged step prints a ``{"step": ...}`` line,
the summary prints as ``{"final": {...}}`` and, when
``PLX_ARTIFACTS_PATH`` is set, lands in ``outputs/final.json`` there.
"""

from __future__ import annotations

import json
import os
from dataclasses import replace
from typing import Any, Callable, Optional

import torch

from ..train.checkpoint import CheckpointConfig

#: keys of the JAX runtime the port does not take yet -> ROADMAP item
_NOT_PORTED = {
    "lora": "A12 (LoRA)",
    "profile": "A5 (profiling into run artifacts)",
    "partition_rules": "A6 (sharding rules)",
    "pp_microbatches": "A9 (pipeline)",
    "pp_remat_ticks": "A9 (pipeline)",
    "pp_gate": "A9 (pipeline)",
    "moe_dispatch": "A10 (MoE)",
    "moe_cap_block": "A10 (MoE)",
    "chaos": "A5 (trainer chaos injection)",
    "resources": "A5 (resource telemetry)",
    "progress_interval": "A5 (progress heartbeats)",
    "num_cpu_devices": "A6 (device meshes)",
    "image_size": "A11 (vision models)",
}

_KNOWN = {
    "model", "steps", "batch_size", "seq_len", "learning_rate", "warmup_steps",
    "schedule", "optimizer", "remat", "attn_block_q", "attn_block_k",
    "attn_block_q_bwd", "attn_block_k_bwd", "loss_chunk_tokens", "mu_dtype",
    "nu_dtype", "grad_dtype", "accum_dtype", "microbatches", "data", "log_interval",
    "anomaly_skip_budget", "anomaly_rollback_budget", "watchdog", "parallelism",
    "num_slices", "checkpoint", "import", "fork_from", "platform",
}
_CHECKPOINT_KEYS = {"save_interval_steps", "max_to_keep", "async_save"}
_IMPORT_KEYS = {"path", "layout", "dtype", "key_map", "transpose"}
_FORK_KEYS = {"path", "step"}


def _refuse_unsupported(spec: dict) -> None:
    """Raise on every key or value the port does not support."""
    for key, value in spec.items():
        if key in _NOT_PORTED:
            # `resources: false` asks for what the port does anyway
            if key == "resources" and value is False:
                continue
            raise SystemExit(f"{key}: not ported to polyaxon_tpu_torch yet "
                             f"(ROADMAP {_NOT_PORTED[key]})")
        if key not in _KNOWN:
            raise SystemExit(f"unknown spec key {key!r} for the port's builtin runtime")
    for key, allowed in (("checkpoint", _CHECKPOINT_KEYS), ("import", _IMPORT_KEYS),
                         ("fork_from", _FORK_KEYS)):
        value = spec.get(key)
        if isinstance(value, dict):
            unknown = set(value) - allowed
            if unknown:
                raise SystemExit(f"{key}: unknown keys {sorted(unknown)}; "
                                 f"valid: {sorted(allowed)}")
        elif key != "checkpoint" and value is not None:
            raise SystemExit(f"{key}: needs a mapping with a path, got {value!r}")
    for key in ("import", "fork_from"):
        if spec.get(key) is not None and not spec[key].get("path"):
            raise SystemExit(f"{key}: needs a path")
    if spec.get("optimizer", "adamw") != "adamw":
        raise SystemExit(f"optimizer {spec['optimizer']!r}: only adamw is ported "
                         f"(ROADMAP A4)")
    para = spec.get("parallelism")
    if para is not None and any(int(v) != 1 for v in dict(para).values()):
        raise SystemExit(f"parallelism {para}: the port trains on one device; "
                         f"meshes wait for ROADMAP A6")
    if int(spec.get("num_slices", 1)) != 1:
        raise SystemExit("num_slices > 1: multislice waits for ROADMAP A6")
    data = dict(spec.get("data") or {})
    if data.get("kind", "synthetic-lm") != "synthetic-lm" or "path" in data:
        raise SystemExit(f"data {data}: only synthetic-lm is ported (tokens-file "
                         f"data waits for ROADMAP A4)")
    unknown = set(data) - {"kind", "seed"}
    if unknown:
        raise SystemExit(f"data keys {sorted(unknown)} are not ported (ROADMAP A4)")


def resolve_device(spec: dict) -> torch.device:
    """CUDA by default (raises without a device); the CPU only when asked."""
    platform = spec.get("platform") or "cuda"
    if platform == "cpu":
        return torch.device("cpu")
    if platform == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("platform 'cuda' needs a usable CUDA device and none is "
                               "available; pass platform: cpu to train on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    raise ValueError(f"unknown platform {platform!r}; valid: cuda|cpu")


def _accelerator(device: torch.device) -> Optional[str]:
    """The meter's peak-table entry for the device (None: no MFU)."""
    if device.type == "cuda" and "H100" in torch.cuda.get_device_name(device):
        return "h100"
    return None


def build_trainer(spec: dict[str, Any],
                  track: Optional[Callable[[int, dict], None]] = None):
    """The spec's Trainer and its data stream (at batch 0), as
    :func:`run_builtin` trains them; raises on every key the port does not
    support."""
    from ..models import REGISTRY
    from ..train import (
        DataConfig, OptimizerConfig, Trainer, TrainerConfig, make_batches, task_for,
    )

    _refuse_unsupported(spec)
    name = spec.get("model", "llama-tiny")
    if name not in REGISTRY:
        raise SystemExit(f"Unknown model {name!r}; available: {sorted(REGISTRY)}")
    family, mcfg = REGISTRY[name]
    if family != "lm":
        raise SystemExit(f"no builtin task for model family {family!r} in the port")
    device = resolve_device(spec)

    overrides: dict[str, Any] = {}
    if spec.get("remat"):
        overrides["remat"] = spec["remat"]
    if spec.get("loss_chunk_tokens") is not None:
        overrides["loss_chunk_tokens"] = int(spec["loss_chunk_tokens"])
    for knob in ("attn_block_q", "attn_block_k", "attn_block_q_bwd", "attn_block_k_bwd"):
        if spec.get(knob) is not None:
            overrides[knob] = int(spec[knob])
    seq_len = int(spec.get("seq_len", min(2048, mcfg.max_seq)))
    if seq_len > mcfg.max_seq:
        overrides["max_seq"] = seq_len
    if overrides:
        mcfg = replace(mcfg, **overrides)
    task = task_for(family, mcfg)

    steps = int(spec.get("steps", 100))
    batch_size = int(spec.get("batch_size", 8))
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

    def _track(step: int, metrics: dict) -> None:
        print(json.dumps({"step": step, **metrics}), flush=True)
        if track is not None:
            track(step, metrics)

    trainer = Trainer(tcfg, device=device, task=task, track=_track)
    data_spec = dict(spec.get("data") or {})
    batches = make_batches(DataConfig(
        kind=data_spec.get("kind", task.default_data_kind), batch_size=batch_size,
        seq_len=seq_len, vocab_size=mcfg.vocab_size, seed=int(data_spec.get("seed", 0))))
    return trainer, batches


def run_builtin(spec: dict[str, Any],
                track: Optional[Callable[[int, dict], None]] = None) -> dict[str, Any]:
    """Train ``spec['model']`` for ``spec['steps']`` steps and return the
    summary. ``track(step, metrics)``, when given, also receives each
    logged step's metrics (a library caller's stand-in for tracking)."""
    from ..train.trainer import TrainingDivergedError

    trainer, batches = build_trainer(spec, track)
    device, steps = trainer.device, trainer.cfg.optimizer.total_steps
    state, start_step = trainer.restore_or_init(
        init_params=_initial_params(spec, trainer, trainer.cfg.model, device))
    # a resumed run continues the data stream where the checkpoint left it
    batches.skip(start_step)
    try:
        _, metrics = trainer.fit(batches, num_steps=steps, state=state)
    except TrainingDivergedError as e:
        raise SystemExit(f"training diverged: {e}") from e
    summary = {k: v for k, v in metrics.items() if isinstance(v, (int, float)) or v is None}
    summary["resumed_from_step"] = int(start_step)
    summary["device"] = (torch.cuda.get_device_name(device) if device.type == "cuda"
                         else "cpu")
    artifacts = os.environ.get("PLX_ARTIFACTS_PATH")
    if artifacts:
        out_dir = os.path.join(artifacts, "outputs")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "final.json"), "w") as f:
            json.dump(summary, f)
    print(json.dumps({"final": summary}), flush=True)
    return summary


def _initial_params(spec: dict, trainer, mcfg, device) -> Optional[dict]:
    """Params to start from instead of a fresh init: ``import:`` (a foreign
    checkpoint) or ``fork_from:`` (another run's checkpoint, read-only).
    None when neither is asked for, or when the run has a complete
    checkpoint of its own — resume beats re-import and re-fork."""
    import_spec, fork_spec = spec.get("import"), spec.get("fork_from")
    if not (import_spec or fork_spec):
        return None
    if trainer.checkpointer is not None \
            and trainer.checkpointer.latest_complete_step() is not None:
        print("[builtin] complete checkpoint found; skipping "
              f"{'import' if import_spec else 'fork restore'}", flush=True)
        return None
    params = None
    if import_spec:
        from ..partition import convert as pconvert

        params = pconvert.import_params(
            import_spec["path"], mcfg, device=device,
            layout=import_spec.get("layout", "auto"),
            dtype=import_spec.get("dtype"),
            key_map=import_spec.get("key_map"),
            transpose=import_spec.get("transpose"))
    if fork_spec:
        from ..train.checkpoint import Checkpointer, to_device

        ro = Checkpointer(CheckpointConfig(directory=fork_spec["path"]), read_only=True)
        fork_step = fork_spec.get("step")
        try:
            raw, restored = ro.restore_raw(
                step=int(fork_step) if fork_step is not None else None)
        except Exception as e:
            if fork_step is None:
                raise
            # the pinned step tore with the parent's preemption: fall back
            # to the parent's newest complete step
            raw, restored = ro.restore_raw()
            print(f"[builtin] fork step {fork_step} not restorable ({e}); "
                  f"using parent step {restored}", flush=True)
        params = to_device(raw["params"], device)
        print(f"[builtin] forked from {fork_spec['path']} @ step {restored}",
              flush=True)
    return params


def main() -> None:
    raw = os.environ.get("PLX_BUILTIN_SPEC")
    if not raw:
        raise SystemExit("PLX_BUILTIN_SPEC not set")
    run_builtin(json.loads(raw))


if __name__ == "__main__":
    main()
