"""The port's builtin training runtime (``polyaxon_tpu_torch.runtime.builtin``)
on the CPU: the llama-tiny run prints the JAX runtime's ``{"final": ...}``
line with the meter's keys, every key the port does not support raises,
and the default platform needs a CUDA device. Then checkpoints: on by
default, a run killed after its fourth step resumes onto the uninterrupted
loss curve exactly, a planted NaN burst rolls back and replays to parity
(``tests/test_selfheal.py`` TestDivergenceGuard, on the port), ``import:``
and ``fork_from:`` start from the given params, and a ``checkpoint:``
restore serves the trained params through ``build_engine``.

Its numbers are held against the JAX package by the trainer parity tests
(``tests/test_torch_train_step.py``); these check the entry point."""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from polyaxon_tpu_torch.models import REGISTRY, transformer
from polyaxon_tpu_torch.partition.convert import save_flat
from polyaxon_tpu_torch.runtime.builtin import run_builtin
from polyaxon_tpu_torch.serve.engine import SamplingParams, ServeEngine
from polyaxon_tpu_torch.serve.runtime import build_engine
from polyaxon_tpu_torch.train import (
    DataConfig, OptimizerConfig, Trainer, TrainerConfig, TrainingDivergedError,
    make_batches, task_for,
)
from polyaxon_tpu_torch.train.checkpoint import CheckpointConfig, Checkpointer

ROOT = Path(__file__).resolve().parents[1]
TINY = {"model": "llama-tiny", "platform": "cpu", "checkpoint": False, "steps": 3,
        "batch_size": 4, "seq_len": 32, "microbatches": 2, "log_interval": 1,
        "watchdog": False}
METER_KEYS = ("steps", "step_time_ms", "step_time_p50_ms", "step_time_p95_ms",
              "tokens_per_sec", "tokens_per_sec_per_chip", "achieved_tflops_per_chip",
              "mfu")


def test_cpu_run_prints_the_final_line_with_the_meter_keys(capsys):
    tracked = []
    summary = run_builtin(dict(TINY), track=lambda step, m: tracked.append(step))
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    final = lines[-1]["final"]
    assert final == json.loads(json.dumps(summary))
    for key in METER_KEYS + ("loss", "grad_norm", "train_anomalies_loss",
                             "train_anomalies_grad", "resumed_from_step"):
        assert key in final, key
    assert final["steps"] == 2 and final["mfu"] is None and final["device"] == "cpu"
    assert [x["step"] for x in lines[:-1]] == [0, 1, 2] == tracked


class _ForModel(dict):
    """A spec value whose case runs another model than TINY's."""

    def __init__(self, value: dict, model: str):
        super().__init__(value)
        self.model = model


@pytest.mark.parametrize("key,value,match", [
    ("checkpoint", {"save_every": 2}, "unknown keys"),
    ("fork_from", "/parent/run", "needs a mapping"),
    ("import", {"path": "/x", "shards": 2}, "unknown keys"),
    # lora is taken by the language models alone, in the JAX runtime's words
    ("lora", _ForModel({"rank": 4}, "resnet18-cifar"), "only supported for LM/MLM models"),
    ("parallelism", {"data": 2}, "Mesh needs 2 devices but only 1 available"),
    # a ResNet replicates its compute over model and context: both run, and
    # at one process their meshes are too big, in build_mesh's words
    ("parallelism", _ForModel({"model": 2}, "resnet18-cifar"),
     "Mesh needs 2 devices but only 1 available"),
    ("parallelism", _ForModel({"context": 2}, "resnet18-cifar"),
     "Mesh needs 2 devices but only 1 available"),
    # stage and expert run: at one process their meshes are too big, in
    # build_mesh's (the JAX package's) words
    ("parallelism", {"stage": 2}, "Mesh needs 2 devices but only 1 available"),
    ("parallelism", {"expert": 2}, "Mesh needs 2 devices but only 1 available"),
    ("parallelism", {"tensor": 2}, "Unknown mesh axes"),
    # one process does not split into two slices, in build_mesh's words
    ("num_slices", 2, "1 devices not divisible by num_slices=2"),
    ("num_cpu_devices", 8, "N gloo ranks"),
    ("profile", {"every": 2}, "unknown keys"),
    ("optimizer", "adam8bit", "unknown; valid: adamw"),
    ("data", {"kind": "tokens-file"}, "needs a path"),
    ("data", {"kind": "tfrecords"}, "unknown; valid"),
    ("data", {"shuffle": True}, "unknown keys"),
    ("image_size", 64, "only resnet models take it"),
    # the JAX package's errors for values its model code does not take
    ("pp_gate", "sometimes", "unknown gate mode 'sometimes'; valid: auto"),
    ("moe_dispatch", "scatter", "unknown moe_dispatch 'scatter'; valid: capacity|a2a|dense"),
    ("chaos", {"hang_after_requests": 3}, "unknown keys"),
    ("partition_rules", [["a", "b"]], "spec 'b' must be null, 'replicated', or a list"),
    ("resources", {"period": 5}, "unknown keys"),
    ("unknown_knob", 1, "unknown spec key"),
])
def test_unsupported_keys_raise_naming_their_roadmap_item(key, value, match):
    spec = dict(TINY, **{key: value})
    if isinstance(value, _ForModel):
        # another family's model: without TINY's language-model keys
        spec["model"] = value.model
        spec.pop("seq_len", None)
    with pytest.raises(SystemExit, match=match):
        run_builtin(spec)


@pytest.mark.parametrize("key,value", [
    ("profile", {"steps": 1}),
    ("chaos", {"nan_at_step": 1}),
    ("resources", {"interval": 0.05}),
])
def test_bridge_keys_are_taken(key, value, tmp_path, monkeypatch):
    """The keys the tracking bridge brought: a profile trace of the last
    step as a `profile` artifact, a NaN planted at step 1 and skipped with
    its budget kept in the artifacts directory, resource telemetry in the
    run's events."""
    from polyaxon_tpu_torch.tracking import read_events

    monkeypatch.setenv("PLX_ARTIFACTS_PATH", str(tmp_path))
    summary = run_builtin(dict(TINY, steps=4, **{key: value}))
    if key == "profile":
        trace = tmp_path / "outputs" / "profile" / "trace.json"
        assert trace.stat().st_size > 0 and json.loads(trace.read_text())["traceEvents"]
        assert [e.artifact.path for e in read_events(str(tmp_path), "artifact", "profile")] \
            == ["outputs/profile"]
        # the meter reads the steps before the profiled one
        assert summary["steps"] == 2
    elif key == "chaos":
        assert summary["train_anomalies_loss"] == 1
        assert json.loads((tmp_path / "chaos-train.json").read_text())["nans"] == 1
    else:
        assert read_events(str(tmp_path), "metric", "host_mem_used_gib")


@pytest.mark.parametrize("model,key,value", [
    ("llama-tiny", "pp_microbatches", 4),
    ("llama-tiny", "pp_remat_ticks", True),
    ("llama-tiny", "pp_gate", "none"),
    ("llama-moe-tiny", "moe_dispatch", "a2a"),
    ("llama-moe-tiny", "moe_cap_block", 8),
])
def test_pipeline_and_moe_keys_are_taken(model, key, value):
    """The JAX runtime's pipeline and MoE keys reach the model config (at
    one process the pipeline keys have no stage to act on, as in the JAX
    runtime); an MoE run reports the router's metrics."""
    from polyaxon_tpu_torch.runtime.builtin import build_trainer

    spec = dict(TINY, model=model, steps=1, **{key: value})
    trainer, _ = build_trainer(spec)
    assert getattr(trainer.task.cfg, key) == value
    summary = run_builtin(spec)
    assert math.isfinite(summary["loss"])
    if model == "llama-moe-tiny":
        assert summary["router_aux"] >= 1.0 - 1e-3 and 0 <= summary["router_drop_frac"] <= 1


def test_the_default_platform_needs_a_cuda_device():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    spec = {k: v for k, v in TINY.items() if k != "platform"}
    with pytest.raises(RuntimeError, match="CUDA device"):
        run_builtin(spec)


def test_module_entry_reads_the_spec_and_writes_final_json(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT), PLX_ARTIFACTS_PATH=str(tmp_path),
               PLX_BUILTIN_SPEC=json.dumps(dict(TINY, steps=2)))
    proc = subprocess.run([sys.executable, "-m", "polyaxon_tpu_torch.runtime.builtin"],
                          cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    final = json.loads(proc.stdout.strip().splitlines()[-1])["final"]
    assert json.loads((tmp_path / "outputs" / "final.json").read_text()) == final
    assert final["steps"] == 1


# -- checkpoints, resume, rollback, import, fork --------------------------------

RUN = dict(TINY, microbatches=1, batch_size=2, steps=5)


def _losses(spec):
    losses = {}
    summary = run_builtin(dict(spec), track=lambda i, m: losses.__setitem__(i, m["loss"]))
    return summary, losses


def _step0_loss(params, spec=RUN):
    """The loss a run's first step reports for ``params``: batch 0 of its
    data stream through the task's loss."""
    cfg = REGISTRY[spec["model"]][1]
    batch = next(make_batches(DataConfig(batch_size=spec["batch_size"],
                                         seq_len=spec["seq_len"],
                                         vocab_size=cfg.vocab_size)))
    with torch.no_grad():
        return float(task_for("lm", cfg).loss(params, None, batch)[0])


def test_checkpoints_are_on_by_default(tmp_path, monkeypatch):
    monkeypatch.setenv("PLX_ARTIFACTS_PATH", str(tmp_path))
    spec = {k: v for k, v in RUN.items() if k != "checkpoint"}
    run_builtin(spec)
    ck = Checkpointer(CheckpointConfig(directory=str(tmp_path / "outputs" / "checkpoints")),
                      read_only=True)
    # steps // 4 = 1: every step, the newest three kept, each with its manifest
    assert ck.all_steps() == [3, 4, 5] == ck.complete_steps_desc()[::-1]
    raw, step = ck.restore_raw()
    assert step == 5 and raw["step"] == 5 and raw["opt_state"]["count"] == 5


class _Kill(Exception):
    pass


def test_kill_after_step_3_then_resume_matches_the_uninterrupted_curve(tmp_path,
                                                                      monkeypatch):
    spec = dict(RUN, checkpoint={"save_interval_steps": 1, "async_save": False})
    monkeypatch.setenv("PLX_ARTIFACTS_PATH", str(tmp_path / "oracle"))
    _, oracle = _losses(spec)
    monkeypatch.setenv("PLX_ARTIFACTS_PATH", str(tmp_path / "run"))
    killed = {}

    def kill_after_step_3(i, m):
        killed[i] = m["loss"]
        if i == 3:
            raise _Kill()  # step 3 ran; its checkpoint (label 4) never lands

    with pytest.raises(_Kill):
        run_builtin(dict(spec), track=kill_after_step_3)
    summary, resumed = _losses(spec)
    assert summary["resumed_from_step"] == 3
    assert sorted(resumed) == [3, 4]
    assert {**killed, **resumed} == oracle   # exactly, step by step
    assert summary["loss"] == oracle[4]


class _NanBurst:
    """NaN losses at data positions [at, at + count), once each: a replay
    after a rollback runs clean (the fault budget is spent)."""

    def __init__(self, at: int, count: int):
        self.due = set(range(at, at + count))

    def pre_step(self, pos):
        pass

    def nan_due(self, pos):
        if pos in self.due:
            self.due.discard(pos)
            return True
        return False


def _trainer(ckpt_dir=None, chaos=None, skip_budget=3, rollback_budget=2, steps=12):
    cfg = TrainerConfig(
        model=REGISTRY["llama-tiny"][1],
        optimizer=OptimizerConfig(learning_rate=1e-3, warmup_steps=2, total_steps=steps),
        batch_size=2, seq_len=32, accelerator=None,
        checkpoint=(CheckpointConfig(directory=ckpt_dir, save_interval_steps=3,
                                     max_to_keep=5, async_save=False)
                    if ckpt_dir else None),
        anomaly_skip_budget=skip_budget, anomaly_rollback_budget=rollback_budget)
    return Trainer(cfg, device="cpu", chaos=chaos)


def _lm_data():
    return make_batches(DataConfig(batch_size=2, seq_len=32, vocab_size=256, seed=7))


class TestDivergenceGuard:
    STEPS = 12

    @pytest.fixture(scope="class")
    def oracle(self):
        _, m = _trainer(steps=self.STEPS).fit(_lm_data(), num_steps=self.STEPS)
        return m

    def test_nan_burst_rolls_back_and_replays_to_exact_parity(self, tmp_path, oracle):
        tr = _trainer(ckpt_dir=str(tmp_path / "ck"), chaos=_NanBurst(7, 2),
                      skip_budget=2, steps=self.STEPS)
        _, m = tr.fit(_lm_data(), num_steps=self.STEPS)
        assert m["train_anomalies_loss"] == 2
        assert m["train_rollbacks"] == 1
        assert np.isfinite(m["loss"])
        assert m["loss"] == oracle["loss"]
        # the replay's saves reuse the rolled-back labels; the final step too
        assert tr.checkpointer.latest_complete_step() == self.STEPS

    def test_the_tracking_hooks_see_each_step_save_and_the_rollback(self, tmp_path, oracle):
        """The JAX trainer's hooks, fired at its places: progress after every
        dispatched step (the replay included), spans for the first step,
        each save, the rollback and the train window, the loop's lines
        through log_line — and the run's numbers unchanged by them."""
        spans, progress, lines = [], [], []
        tr = _trainer(ckpt_dir=str(tmp_path / "ck"), chaos=_NanBurst(7, 2),
                      skip_budget=2, steps=self.STEPS)
        tr.on_span = lambda name, start, end, **meta: spans.append((name, meta, end >= start))
        tr.on_progress = lambda i, anomalies, rollbacks: progress.append(
            (i, dict(anomalies), rollbacks))
        tr.log_line = lines.append
        _, m = tr.fit(_lm_data(), num_steps=self.STEPS)
        assert m["loss"] == oracle["loss"]
        assert all(ok for _, _, ok in spans)
        # saves: the first always goes, then every 3rd label, the replay's
        # re-save of a rolled-back label, and the final one
        assert [(n, meta.get("step")) for n, meta, _ in spans] == [
            ("first-step-compiled", 0), ("checkpoint-save", 1), ("checkpoint-save", 3),
            ("checkpoint-save", 6), ("rollback", 6), ("checkpoint-save", 9),
            ("checkpoint-save", 12), ("train", None)]
        assert spans[4][1] == {"step": 6, "from_step": 8, "rollbacks": 1}
        assert [i for i, _, _ in progress] == list(range(9)) + list(range(6, 12))
        assert progress[-1] == (11, {"loss": 2, "grad": 0}, 1)
        assert any("rolled back to checkpoint step 6" in x for x in lines)

    def test_isolated_anomaly_skipped_without_rollback(self, oracle):
        tr = _trainer(chaos=_NanBurst(5, 1), skip_budget=3, steps=self.STEPS)
        _, m = tr.fit(_lm_data(), num_steps=self.STEPS)
        assert m["train_anomalies_loss"] == 1 and m["train_rollbacks"] == 0
        assert np.isfinite(m["loss"])
        assert m["loss"] == pytest.approx(oracle["loss"], rel=0.05)
        assert m["loss"] != oracle["loss"]  # one update is missing

    def test_exhausted_budgets_fail_loudly_with_history(self, tmp_path):
        tr = _trainer(ckpt_dir=str(tmp_path / "ck"), chaos=_NanBurst(4, 40),
                      skip_budget=2, rollback_budget=1, steps=self.STEPS)
        with pytest.raises(TrainingDivergedError) as exc:
            tr.fit(_lm_data(), num_steps=self.STEPS)
        err = exc.value
        assert err.rollbacks == 1 and err.anomalies["loss"] >= 4
        assert [h["step"] for h in err.history][:2] == [4, 5]


def test_import_starts_from_the_given_params_and_resume_beats_it(tmp_path, monkeypatch,
                                                                  capsys):
    cfg = REGISTRY["llama-tiny"][1]
    given = transformer.init(cfg, seed=5, device="cpu")
    save_flat(given, str(tmp_path / "export"))
    monkeypatch.setenv("PLX_ARTIFACTS_PATH", str(tmp_path / "run"))
    spec = dict(RUN, steps=2, checkpoint={"save_interval_steps": 1},
                **{"import": {"path": str(tmp_path / "export"), "layout": "flat"}})
    _, losses = _losses(spec)
    assert losses[0] == _step0_loss(given)
    summary, _ = _losses(dict(spec, steps=3))
    assert summary["resumed_from_step"] == 2
    assert "complete checkpoint found; skipping import" in capsys.readouterr().out


def test_fork_from_starts_from_the_parent_checkpoint(tmp_path, monkeypatch):
    monkeypatch.setenv("PLX_ARTIFACTS_PATH", str(tmp_path / "parent"))
    run_builtin(dict(RUN, steps=3, checkpoint={"save_interval_steps": 1, "max_to_keep": 5}))
    parent = str(tmp_path / "parent" / "outputs" / "checkpoints")
    ro = Checkpointer(CheckpointConfig(directory=parent), read_only=True)
    for pinned, want_step in ((None, 3), (2, 2)):
        raw, step = ro.restore_raw(step=want_step)
        fork = {"path": parent} if pinned is None else {"path": parent, "step": pinned}
        monkeypatch.setenv("PLX_ARTIFACTS_PATH", str(tmp_path / f"child{pinned}"))
        summary, losses = _losses(dict(RUN, steps=1, **{"fork_from": fork}))
        assert summary["resumed_from_step"] == 0
        assert losses[0] == _step0_loss(raw["params"])
    # the parent's directory is untouched by its readers
    assert ro.all_steps() == [1, 2, 3]


def test_checkpoint_restore_serves_the_trained_params(tmp_path, monkeypatch):
    monkeypatch.setenv("PLX_ARTIFACTS_PATH", str(tmp_path))
    run_builtin(dict(RUN, steps=2, checkpoint={"save_interval_steps": 1}))
    ckdir = str(tmp_path / "outputs" / "checkpoints")
    raw, step = Checkpointer(CheckpointConfig(directory=ckdir), read_only=True).restore_raw()
    engine = build_engine({"model": "llama-tiny", "platform": "cpu", "block_size": 8,
                           "max_seq_len": 64, "prefill_chunk": 16,
                           "checkpoint": {"path": ckdir}})
    assert engine.provenance == {"restored_from": ckdir, "restored_step": 2}
    for (path, a), (_, b) in zip(transformer.flatten(engine.params),
                                 transformer.flatten(raw["params"])):
        assert torch.equal(a, b), path
    direct = ServeEngine(raw["params"], REGISTRY["llama-tiny"][1], block_size=8,
                         max_seq_len=64, prefill_chunk=16)
    prompt = list(range(3, 14))
    for e in (engine, direct):
        e.start()
    try:
        got = [e.generate(prompt, SamplingParams(max_new_tokens=6), timeout=60).out_tokens
               for e in (engine, direct)]
    finally:
        for e in (engine, direct):
            e.stop()
    assert got[0] == got[1] and len(got[0]) == 6


# -- every family and optimizer through the runtime ------------------------------

FAMILY_BASE = {"platform": "cpu", "steps": 5, "batch_size": 2, "log_interval": 1,
               "watchdog": False, "warmup_steps": 1,
               "checkpoint": {"save_interval_steps": 1, "async_save": False}}
FAMILY_RUNS = {
    "bert-tiny": dict(model="bert-tiny", seq_len=32),
    "vit-tiny": dict(model="vit-tiny", microbatches=2),
    # at 16-pixel images: bf16 convolutions are slow on the CPU, and the
    # resume path is the same at any image size
    "resnet18-cifar": dict(model="resnet18-cifar", optimizer="sgd", learning_rate=0.1,
                           image_size=16),
    "llama-tiny-sgd": dict(model="llama-tiny", seq_len=32, optimizer="sgd"),
    "llama-tiny-lion": dict(model="llama-tiny", seq_len=32, optimizer="lion",
                            mu_dtype="bfloat16"),
    "llama-tiny-adafactor": dict(model="llama-tiny", seq_len=32, optimizer="adafactor"),
}


def _final_state(tmp_path, run):
    ck = Checkpointer(CheckpointConfig(directory=str(tmp_path / run / "outputs" /
                                                     "checkpoints")), read_only=True)
    return ck.restore_raw()


@pytest.mark.parametrize("case", sorted(FAMILY_RUNS))
def test_each_family_and_optimizer_resumes_onto_the_uninterrupted_curve(case, tmp_path,
                                                                       monkeypatch):
    """A run killed after its fourth step resumes from the port's checkpoint
    (params, the optimizer's state, ResNet's batch statistics in ``extra``)
    onto the uninterrupted loss curve, step for step, and ends in the same
    state, bit for bit."""
    from polyaxon_tpu_torch.partition.rules import tree_paths

    spec = {**FAMILY_BASE, **FAMILY_RUNS[case]}
    monkeypatch.setenv("PLX_ARTIFACTS_PATH", str(tmp_path / "oracle"))
    summary, oracle = _losses(spec)
    assert sorted(oracle) == [0, 1, 2, 3, 4]
    assert all(np.isfinite(v) for v in oracle.values())
    vision = REGISTRY[spec["model"]][0] in ("vit", "resnet")
    assert ("accuracy" in summary) == vision
    monkeypatch.setenv("PLX_ARTIFACTS_PATH", str(tmp_path / "run"))
    killed = {}

    def kill_after_step_3(i, m):
        killed[i] = m["loss"]
        if i == 3:
            raise _Kill()

    with pytest.raises(_Kill):
        run_builtin(dict(spec), track=kill_after_step_3)
    resumed_summary, resumed = _losses(spec)
    assert resumed_summary["resumed_from_step"] == 3
    assert {**killed, **resumed} == oracle
    (want, _), (got, _) = _final_state(tmp_path, "oracle"), _final_state(tmp_path, "run")
    want_leaves, got_leaves = tree_paths(want), tree_paths(got)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, a), (_, b) in zip(got_leaves, want_leaves):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), path
        else:
            assert a == b, path
    if case == "resnet18-cifar":
        stats = dict(tree_paths(got["extra"]))
        assert not torch.equal(stats["stem_bn/var"], torch.ones_like(stats["stem_bn/var"]))


def test_a_resnet_fork_starts_from_the_parent_s_params_and_batch_statistics(tmp_path,
                                                                            monkeypatch):
    from polyaxon_tpu_torch.partition.rules import tree_paths

    spec = {**FAMILY_BASE, **FAMILY_RUNS["resnet18-cifar"], "steps": 2}
    monkeypatch.setenv("PLX_ARTIFACTS_PATH", str(tmp_path / "parent"))
    run_builtin(dict(spec))
    parent = str(tmp_path / "parent" / "outputs" / "checkpoints")
    raw, _ = Checkpointer(CheckpointConfig(directory=parent), read_only=True).restore_raw()
    monkeypatch.setenv("PLX_ARTIFACTS_PATH", str(tmp_path / "child"))
    seen = {}

    class Probe(Trainer):
        def restore_or_init(self, *args, **kwargs):
            state, step = super().restore_or_init(*args, **kwargs)
            seen["extra"] = {p: t.clone() for p, t in tree_paths(state.extra)}
            return state, step

    import polyaxon_tpu_torch.train as train_pkg

    monkeypatch.setattr(train_pkg, "Trainer", Probe)
    summary = run_builtin({**spec, "steps": 1, "fork_from": {"path": parent}})
    assert summary["resumed_from_step"] == 0 and np.isfinite(summary["loss"])
    parent_stats = dict(tree_paths(raw["extra"]))
    assert seen["extra"].keys() == parent_stats.keys()
    assert all(torch.equal(t, parent_stats[p]) for p, t in seen["extra"].items())


def test_vision_accuracy_reaches_the_tracked_run(tmp_path, monkeypatch):
    from polyaxon_tpu_torch.tracking import read_events

    monkeypatch.setenv("PLX_ARTIFACTS_PATH", str(tmp_path))
    summary = run_builtin({**FAMILY_BASE, "model": "vit-tiny", "checkpoint": False,
                           "steps": 3, "microbatches": 2})
    events = read_events(str(tmp_path), "metric", "accuracy")
    assert [e.step for e in events] == [0, 1, 2]
    assert events[-1].metric == summary["accuracy"]
    outputs = json.loads((tmp_path / "outputs.json").read_text())
    assert outputs["accuracy"] == summary["accuracy"]


@pytest.mark.parametrize("model,key,value,match", [
    ("vit-tiny", "import", {"path": "/x"}, "only supported for LM/MLM"),
    ("resnet18-cifar", "import", {"path": "/x"}, "only supported for LM/MLM"),
    ("vit-tiny", "seq_len", 64, "only language models take them"),
    ("resnet18-cifar", "remat", "full", "only language models take them"),
    ("vit-tiny", "image_size", 64, "only resnet models take it"),
    ("resnet18-cifar", "pp_microbatches", 4, "only language models take them"),
    ("vit-tiny", "moe_dispatch", "a2a", "only language models take them"),
    # the JAX trainer's refusal: a ResNet has no layered trunk to pipeline
    ("resnet18-cifar", "parallelism", {"stage": 2}, "needs a layered transformer trunk"),
    ("bert-tiny", "parallelism", {"data": 4}, "Mesh needs 4 devices but only 1"),
])
def test_family_refusals(model, key, value, match):
    spec = {**FAMILY_BASE, "model": model, "checkpoint": False, key: value}
    with pytest.raises(SystemExit, match=match):
        run_builtin(spec)


def test_resnet_image_size_sets_the_stream_and_the_flops():
    from polyaxon_tpu_torch.runtime.builtin import build_trainer

    trainer, batches = build_trainer({**FAMILY_BASE, "model": "resnet18-cifar",
                                      "checkpoint": False, "image_size": 40})
    assert tuple(next(batches)["images"].shape) == (2, 40, 40, 3)
    assert trainer.task.image_size == 40
    trainer, batches = build_trainer({**FAMILY_BASE, "model": "vit-tiny", "checkpoint": False})
    assert tuple(next(batches)["images"].shape) == (2, 32, 32, 3)
    assert trainer.cfg.seq_len == 17
