"""Port parity: the training step of ``polyaxon_tpu_torch.train`` (schedule,
AdamW, data, Trainer.fit and its divergence guard) against the JAX package
on the CPU, from the same weights and numpy-seeded data.

Tolerances. Schedules: optax evaluates them in f32 (its cosine too), the
port in f64 rounded to f32: a few f32 places (1e-6 relative). AdamW: the same f32 formulas in the
same order, so updates and moments agree to 1e-6 relative (f32) and to
one bf16 place where a moment is stored in bf16. Loss curve: five llama-
tiny steps (microbatches 2) in f32; the first loss agrees to 2e-5 like
the model test, and Adam's m/sqrt(v) amplifies last-place grad differences
on near-zero grads, so the curve is held to 1e-4 relative.
"""

from __future__ import annotations

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from polyaxon_tpu.models import llama as jllama
from polyaxon_tpu.train import data as jdata
from polyaxon_tpu.train import optimizers as jopt
from polyaxon_tpu.train.trainer import Trainer as JaxTrainer
from polyaxon_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from polyaxon_tpu_torch.convert import params_from_jax
from polyaxon_tpu_torch.models import REGISTRY, llama
from polyaxon_tpu_torch.train import data, optimizers
from polyaxon_tpu_torch.models.transformer import flatten
from polyaxon_tpu_torch.train.trainer import Trainer, TrainerConfig, TrainingDivergedError
from polyaxon_tpu_torch.train.watchdog import WATCHDOG_EXIT_CODE, StepWatchdog


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("warmup", [0, 3])
def test_schedule_matches_optax(schedule, warmup):
    kw = dict(learning_rate=3e-4, warmup_steps=warmup, total_steps=10, schedule=schedule)
    ref = jopt.make_schedule(jopt.OptimizerConfig(**kw))
    ours = optimizers.make_schedule(optimizers.OptimizerConfig(**kw))
    for count in range(13):
        assert ours(count) == pytest.approx(float(ref(count)), rel=1e-6, abs=1e-12), count
    if warmup:
        assert ours(0) == 0.0  # the first update is zero


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": {"w": (rng.standard_normal((6, 5)) * scale).astype(np.float32)},
            "b": (rng.standard_normal((7,)) * scale).astype(np.float32)}


def _leaves(tree):
    return [np.asarray(leaf, np.float32) for _, leaf in flatten(tree)]


# (mu_dtype, nu_dtype, grad dtype): optax.adamw in f32 and with bf16 mu;
# scale_by_adam_lowmem with f32 grads and with the recipe's bf16 grads
@pytest.mark.parametrize("mu_dtype,nu_dtype,grad_dtype", [
    (None, None, "float32"), ("bfloat16", None, "float32"),
    ("bfloat16", "bfloat16", "float32"), ("bfloat16", "bfloat16", "bfloat16"),
])
def test_adamw_update_matches_make_optimizer(mu_dtype, nu_dtype, grad_dtype):
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=6, mu_dtype=mu_dtype,
              nu_dtype=nu_dtype, grad_clip=1.0)
    tx = jopt.make_optimizer(jopt.OptimizerConfig(**kw))
    ours = optimizers.make_optimizer(optimizers.OptimizerConfig(**kw))
    params = _tree(0)
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = [torch.tensor(x) for x in _leaves(params)]
    jstate = tx.init(jparams)
    tstate = ours.init(tparams)
    gd = jnp.dtype(grad_dtype)
    for step in range(3):
        grads = _tree(10 + step, scale=2.0)  # global norm > 1: the clip is active
        jg = jax.tree.map(lambda g: jnp.asarray(g).astype(gd), grads)
        tg = [torch.tensor(x).to(getattr(torch, grad_dtype)) for x in _leaves(grads)]
        jupd, jstate = tx.update(jg, jstate, jparams)
        tupd, tstate = ours.update(tg, tstate, tparams)
        for a, b in zip(tupd, _leaves(jupd)):
            np.testing.assert_allclose(a.float().numpy(), b, rtol=1e-6, atol=1e-9)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, jupd)
        tparams = [p + u for p, u in zip(tparams, tupd)]
    adam = jstate[1][0]  # chain(clip, chain(adam, decay, lr))
    jmu = _leaves(adam.mu)
    jnu = _leaves(adam.nu)
    assert int(adam.count) == tstate.count == 3
    for a, b in zip(tstate.mu, jmu):
        assert a.dtype == (torch.bfloat16 if mu_dtype else torch.float32)
        np.testing.assert_allclose(a.float().numpy(), b, rtol=2.0 ** -8, atol=1e-9)
    for a, b in zip(tstate.nu, jnu):
        np.testing.assert_allclose(a.float().numpy(), b, rtol=2.0 ** -8, atol=1e-9)


def test_global_norm_reduces_bf16_leaves_like_optax():
    grads = _tree(3, scale=3.0)
    jg = jax.tree.map(lambda g: jnp.asarray(g).astype(jnp.bfloat16), grads)
    ref = float(jopt.optax.global_norm(jg))
    ours = optimizers.global_norm([torch.tensor(x).bfloat16() for x in _leaves(grads)])
    assert ours.dtype == torch.bfloat16
    assert float(ours) == pytest.approx(ref, rel=2.0 ** -8)


@pytest.mark.parametrize("index", [0, 1, 7])
def test_batches_are_bit_identical(index):
    cfg = dict(kind="synthetic-lm", batch_size=3, seq_len=16, vocab_size=500, seed=5)
    jstream = jdata.make_batches(jdata.DataConfig(**cfg))
    tstream = data.make_batches(data.DataConfig(**cfg))
    jstream.seek(index)
    tstream.skip(index)
    jb, tb = next(jstream), next(tstream)
    for key in ("inputs", "labels"):
        np.testing.assert_array_equal(tb[key].numpy(), np.asarray(jb[key]))
    assert tstream.position == index + 1


def test_other_data_kinds_are_refused():
    with pytest.raises(ValueError, match="Unknown data kind 'tfrecords'"):
        data.make_batches(data.DataConfig(kind="tfrecords"))


STEPS = 5


BATCH = 16  # two microbatches of 8: the JAX step shards a batch over 8 CPU devices


def _configs(**over):
    common = dict(batch_size=BATCH, seq_len=32, microbatches=2, log_interval=1)
    opt = dict(learning_rate=1e-3, warmup_steps=2, total_steps=STEPS)
    return (JaxTrainerConfig(model=jllama.LLAMA_TINY, parallelism={"data": 1},
                             optimizer=jopt.OptimizerConfig(**opt), **common),
            TrainerConfig(**{"model": llama.LLAMA_TINY, "accelerator": None,
                             "optimizer": optimizers.OptimizerConfig(**opt), **common,
                             **over}))


def _data(stream_mod, seed=7):
    return stream_mod.make_batches(stream_mod.DataConfig(
        kind="synthetic-lm", batch_size=BATCH, seq_len=32, vocab_size=256, seed=seed))


@pytest.fixture(scope="module")
def jax_run():
    jcfg, _ = _configs()
    trainer = JaxTrainer(jcfg, track=lambda i, m: losses.append(m["loss"]))
    losses: list = []
    state = trainer.init_state(seed=0)
    weights = jax.tree.map(np.asarray, state.params)
    _, final = trainer.fit(_data(jdata), num_steps=STEPS, state=state)
    return weights, losses, final


def _port_trainer(weights, chaos=None, **over):
    _, tcfg = _configs(**over)
    losses: list = []
    trainer = Trainer(tcfg, device="cpu", chaos=chaos,
                      track=lambda i, m: losses.append(m["loss"]))
    state = trainer.init_state_from(params_from_jax(weights, device="cpu"))
    return trainer, state, losses


def test_five_step_fit_tracks_the_jax_loss_curve(jax_run):
    weights, jlosses, jfinal = jax_run
    trainer, state, losses = _port_trainer(weights)
    _, final = trainer.fit(_data(data), num_steps=STEPS, state=state)
    assert len(losses) == STEPS
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert final["grad_norm"] == pytest.approx(jfinal["grad_norm"], rel=1e-4)
    assert final["train_anomalies_loss"] == 0 and final["steps"] == STEPS - 1
    assert final["mfu"] is None  # no peak for a CPU run


class _NaNChaos:
    """The port's stand-in for the JAX package's TrainerChaos: poison the
    loss of ``count`` steps from data position ``at``."""

    def __init__(self, at: int, count: int):
        self.at, self.count = at, count

    def pre_step(self, pos: int) -> None:
        pass

    def nan_due(self, pos: int) -> bool:
        return self.at <= pos < self.at + self.count


def test_a_nan_step_keeps_params_and_optimizer_state(jax_run):
    weights, _, _ = jax_run
    trainer, state, _ = _port_trainer(weights)
    step = trainer.make_step()
    batches = _data(data)
    state, _ = step(state, next(batches))
    before = [t.clone() for _, t in flatten(state.params)]
    mu = [t.clone() for t in state.opt_state.mu]
    count = state.opt_state.count
    state, metrics = step(state, next(batches), True)
    assert float(metrics["anomaly_loss"]) == 1.0 and state.step == 2
    assert all(torch.equal(a, b) for (_, a), b in zip(flatten(state.params), before))
    assert all(torch.equal(a, b) for a, b in zip(state.opt_state.mu, mu))
    assert state.opt_state.count == count  # the schedule and Adam's count freeze


def test_an_isolated_anomaly_is_counted_and_skipped(jax_run):
    weights, _, _ = jax_run
    trainer, state, _ = _port_trainer(weights, chaos=_NaNChaos(at=2, count=1))
    _, final = trainer.fit(_data(data), num_steps=STEPS, state=state)
    assert final["train_anomalies_loss"] == 1 and final["train_rollbacks"] == 0
    assert np.isfinite(final["loss"])


def test_exhausted_skip_budget_raises_with_history(jax_run):
    weights, _, _ = jax_run
    trainer, state, _ = _port_trainer(weights, chaos=_NaNChaos(at=1, count=8),
                                      anomaly_skip_budget=2)
    with pytest.raises(TrainingDivergedError) as exc:
        trainer.fit(_data(data), num_steps=STEPS, state=state)
    assert exc.value.anomalies["loss"] >= 2
    assert [h["step"] for h in exc.value.history][:2] == [1, 2]


@pytest.mark.parametrize("over,error,match", [
    # a mesh larger than the process group, in build_mesh's words
    (dict(parallelism={"data": 2}), ValueError, "Mesh needs 2 devices but only 1 available"),
    (dict(parallelism={"fsdp": 2}), ValueError, "Mesh needs 2 devices but only 1 available"),
    # one process does not split into two slices, in build_mesh's words
    (dict(num_slices=2), ValueError, "1 devices not divisible by num_slices=2"),
    # a ResNet under model is no longer refused (its compute is replicated):
    # without its Task the Trainer raises the JAX Trainer's own error
    (dict(model=REGISTRY["resnet18-cifar"][1], parallelism={"model": 2}),
     ValueError, "model config ResNetConfig needs an explicit Task"),
    # stage runs: at one process its mesh is too big, in build_mesh's (the
    # JAX package's) words
    (dict(parallelism={"stage": 2}), ValueError, "Mesh needs 2 devices but only 1 available"),
])
def test_the_trainer_refuses_what_is_not_ported(over, error, match):
    _, tcfg = _configs(**over)
    with pytest.raises(error, match=match):
        Trainer(tcfg, device="cpu")


# -- the watchdog copy (mirrors tests/test_selfheal.py::TestStepWatchdog) -------


def test_watchdog_fires_on_step_silence_with_stack_dump_and_exit():
    lines, stalls, exits = [], [], []
    done = threading.Event()

    def exit_fn(code):
        exits.append(code)
        done.set()

    wd = StepWatchdog(min_s=0.15, compile_grace_s=0.15, stall_factor=2.0,
                      p95_s=lambda: 0.0, on_stall=lambda *a: stalls.append(a),
                      log=lines.append, exit_fn=exit_fn)
    wd.start()
    wd.beat(7)
    assert done.wait(10.0), "watchdog never fired"
    assert wd.fired and exits == [WATCHDOG_EXIT_CODE]
    step, waited, limit = stalls[0]
    assert step == 7 and waited >= limit >= 0.15
    text = "\n".join(lines)
    assert "--- thread" in text and "test_torch_train_step" in text


@pytest.mark.parametrize("case", ["beating", "p95_deadline", "compile_grace"])
def test_watchdog_stays_quiet(case):
    exits = []
    kw = {"beating": dict(min_s=0.15, compile_grace_s=0.15),
          "p95_deadline": dict(min_s=0.05, compile_grace_s=0.05, stall_factor=4.0,
                               p95_s=lambda: 10.0),
          "compile_grace": dict(min_s=0.05, compile_grace_s=30.0)}[case]
    wd = StepWatchdog(exit_fn=exits.append, **kw)
    wd.start()
    try:
        if case == "beating":
            for i in range(8):
                wd.beat(i)
                time.sleep(0.05)
        elif case == "p95_deadline":
            wd.beat(0)
            time.sleep(0.4)  # past min_s, far under 4 x the 10 s p95
        else:
            time.sleep(0.3)  # past min_s, no beat yet: the grace holds
        assert not wd.fired and exits == []
    finally:
        wd.stop()
