"""The training step's phases as ``torch.profiler`` ranges
(``polyaxon_tpu_torch/obs/spans.py``): a tiny LM trainer, two steps of two
microbatches on the CPU, under the profiler and without it."""

from __future__ import annotations

import collections

import torch
from torch.profiler import ProfilerActivity, profile
from torch_threads import one_torch_thread  # noqa: F401

from polyaxon_tpu_torch.models import llama
from polyaxon_tpu_torch.models.transformer import flatten
from polyaxon_tpu_torch.obs import spans
from polyaxon_tpu_torch.train import data, optimizers
from polyaxon_tpu_torch.train.trainer import Trainer, TrainerConfig

STEPS, MICRO = 2, 2


def _fit(traced: bool):
    cfg = TrainerConfig(model=llama.LLAMA_TINY, accelerator=None, batch_size=8, seq_len=16,
                        microbatches=MICRO, log_interval=1,
                        optimizer=optimizers.OptimizerConfig(learning_rate=1e-3,
                                                             warmup_steps=0, total_steps=4))
    losses: list = []
    trainer = Trainer(cfg, device="cpu", track=lambda i, m: losses.append(m["loss"]))
    state = trainer.init_state(seed=0)
    batches = data.make_batches(data.DataConfig(kind="synthetic-lm", batch_size=8,
                                                seq_len=16, vocab_size=256, seed=3))
    prof = None
    if traced:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            state, _ = trainer.fit(batches, num_steps=STEPS, state=state)
    else:
        state, _ = trainer.fit(batches, num_steps=STEPS, state=state)
    return state, losses, prof


def _ranges(prof) -> list:
    return sorted(((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.name.startswith("train.")), key=lambda r: (r[0], -r[1]))


def test_each_phase_is_a_range_as_often_as_the_step_opens_it():
    _, _, prof = _fit(traced=True)
    ranges = _ranges(prof)
    count = collections.Counter(n for _, _, n in ranges)
    assert count["train.data"] == STEPS and count["train.step"] == STEPS
    assert count["train.optimizer"] == STEPS
    for name in ("train.microbatch", "train.forward", "train.loss", "train.backward"):
        assert count[name] == STEPS * MICRO, name
    # the gate and the anomaly reads a step, and the sync that closes the
    # first and the last step
    assert count["train.sync"] == 3 * STEPS
    assert "train.grad_sync" not in count  # no distributed mesh

    def inside(name, outer):
        return all(any(s <= a and b <= e for s, e, n in ranges if n == outer)
                   for a, b, m in ranges if m == name)

    assert inside("train.loss", "train.forward")
    assert inside("train.forward", "train.microbatch")
    assert inside("train.backward", "train.microbatch")
    assert inside("train.microbatch", "train.step")
    assert inside("train.optimizer", "train.step")


def test_outside_a_profiler_a_span_is_the_one_shared_no_op():
    assert spans.span("train.step") is spans.OFF
    assert spans.span("train.forward") is spans.OFF
    with profile(activities=[ProfilerActivity.CPU]):
        assert spans.span("train.step") is not spans.OFF
    assert spans.span("train.step") is spans.OFF


def test_the_profiled_steps_are_bitwise_the_plain_ones():
    plain, plain_losses, _ = _fit(traced=False)
    traced, traced_losses, _ = _fit(traced=True)
    assert plain_losses == traced_losses and len(plain_losses) == STEPS
    for (path, a), (_, b) in zip(flatten(plain.params), flatten(traced.params)):
        assert torch.equal(a, b), path
