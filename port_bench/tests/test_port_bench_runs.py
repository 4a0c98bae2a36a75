"""The harness driven on the CPU at tiny sizes (the port's ``bert-tiny``
and ``gpt2-tiny``, f32): the plain reference agrees with the port's CPU
path; the control (the reference in float8 in the program's place) and
each fault of a training cell, planted underneath the timed path, come
out not correct."""

from __future__ import annotations

import time

import pytest
import torch

from port_bench import compare, harness, manifest
from port_bench.tests.tiny import CELLS, LIMITS, make_root

CPU = torch.device("cpu")
SEED = 2 ** 31 + 4242


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(1)
    return make_root(tmp_path_factory.mktemp("bench"))


def _run(root, name, trace=False, seconds=0.3):
    cell = manifest.resolve(name, root)
    return harness.run_cell(cell, SEED, seconds, trace, CPU, time.perf_counter())


@pytest.mark.parametrize("name", sorted(CELLS))
def test_the_reference_agrees_with_the_ports_cpu_path(root, name):
    result = _run(root, name)
    assert result["correct"], result["compared"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert list(result)[-1] == "compared"
    for check in result["compared"].values():
        assert check["value"] <= check["limit"] / 10


@pytest.mark.parametrize("name", sorted(CELLS))
def test_the_control_and_the_half_batch_fault_fail_the_comparison(root, name):
    cell = manifest.resolve(name, root)
    prog = harness.program_setup(cell, SEED, CPU)
    pool, spec = prog.feed.pool, prog.spec
    harness.release(prog, CPU)
    ref = harness.reference_readings(cell, spec, SEED, CPU, pool)
    for kw in ({"quant": True}, {"keep_rows": 0.5}):
        other = harness.reference_readings(cell, spec, SEED, CPU, pool, **kw)
        ok, checks = compare.judge(compare.gaps(other, ref), LIMITS)
        assert not ok, (kw, checks)


def _broken_step(monkeypatch, how: str):
    from polyaxon_tpu_torch.train.trainer import Trainer, TrainState

    if how == "state_unchanged":
        make = Trainer.make_step

        def make_step(self):
            step = make(self)

            def unchanged(state, batch, inject=False):
                frozen = {k: v.clone() for k, v in
                          compare.program_mu_and_params(state)[1].items()}
                _, metrics = step(state, batch, inject)
                with torch.no_grad():
                    for path, t in compare.program_mu_and_params(state)[1].items():
                        t.copy_(frozen[path])
                return TrainState(state.params, state.opt_state, state.step + 1,
                                  state.extra), metrics
            return unchanged
        monkeypatch.setattr(Trainer, "make_step", make_step)
    else:
        loss = Trainer._loss

        def half(self, params, extra, batch, inject):
            rows = next(iter(batch.values())).shape[0]
            return loss(self, params, extra,
                        {k: v[: rows // 2] for k, v in batch.items()}, inject)
        monkeypatch.setattr(Trainer, "_loss", half)


@pytest.mark.parametrize("how", ["state_unchanged", "half_batch"])
@pytest.mark.parametrize("name", sorted(CELLS))
def test_a_broken_step_is_not_correct(root, name, how, monkeypatch):
    _broken_step(monkeypatch, how)
    result = _run(root, name)
    assert not result["correct"], result["compared"]


def test_a_traced_run_reports_the_per_layer_metrics_it_can_read(root):
    result = _run(root, "gpt2-tiny.lm-s64", trace=True)
    assert result["correct"]
    assert result["device"]["window_s"] > 0 and "breakdown" in result
    # a CPU run has no device kernels and no peak: no device metric is read
    assert set(result["metrics"]) <= {"peak_mem_gib"}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bert-base.mlm-s512", "gpt2-345m.lm-s1024",
                                  "bert-base.mlm-s128"])
def test_each_cell_runs_correct_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell runs the port's CUDA kernels")
    cell = manifest.resolve(name)
    result = harness.run_cell(cell, SEED, 3.0, False, torch.device("cuda", 0),
                              time.perf_counter())
    assert result["correct"], result["compared"]
