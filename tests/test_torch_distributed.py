"""The port's data and fsdp parallelism on 2-rank gloo groups, against the
JAX package's SPMD trainer on 2-device CPU meshes of the same shape.

One group of two worker processes (``tests/fixtures/torch_dist_worker.py``,
``OMP_NUM_THREADS=2``), then one of four for ``{data: 2, fsdp: 2}``, runs
every case through ``run_builtin`` with
``PLX_*`` env and ``platform: cpu``, three steps each, from the JAX init
(``fork_from`` a port checkpoint of it):

- llama-tiny ``{data: 2}``, ``{fsdp: 2}`` and ``{data: 2}`` at two
  microbatches; bert-tiny ``{data: 2}`` at two microbatches (per-microbatch
  MLM counts); resnet18-cifar ``{data: 2}`` in f32 (batch norms over both
  ranks' rows); llama-tiny ``{fsdp: 2}`` with bf16 grads, as the llama
  recipes train; llama-tiny ``{data: 2, fsdp: 2}`` on four ranks. Per-step loss and grad norm and the final params are held
  against the JAX ``Trainer`` on ``build_mesh(same, devices=jax.devices()[:2])``
  and against the port's own one-process run;
- the three planted faults (per-rank MLM mean, per-rank batch-norm
  statistics, rank-local microbatch order) must each fail the comparison;
- a NaN in one rank's batch makes both ranks skip the step, and a
  transient one with no skip budget rolls both back to the same step;
- checkpoints cross world sizes: ``{fsdp: 2}``'s restore at world 1, and a
  world-1 step restores into ``{fsdp: 2}`` shards, bit-equal; an ``{fsdp:
  2}`` run resumes where it stopped;
- rank 0 alone writes the run's events, ``final.json`` and the
  ``{"final"}`` line.

Tolerances. Against JAX, the one-process parity tests' (tests/test_torch_
families.py): f32 sums in other orders, losses 1e-4 relative over three
AdamW steps; grad norms too. The cross-rank reduction adds one more order
(each rank's partial sums, then their sum) of the same size, so the limits
stay. Final params after three AdamW steps move by up to lr per step where
a grad is near zero and its sign is rounding: 3e-4 absolute at lr 1e-3.
Against the port's one process: 2e-6 relative on losses and grad norms
and 1e-5 absolute on params, all of it the reduction's reordering.

resnet18-cifar has its own row. Its batch-norm grads at 4 rows per rank
are sums that cancel (the one-process test holds them at 1e-2 in norm),
and three AdamW steps amplify their last places: the port's one process
already reads a grad norm 5.7e-4 from JAX's at step 2 (JAX's own 1- and
2-device meshes differ by 8e-5 there), so the grad norm is held at 1e-3;
against the port's one process, 2e-5 on the loss and 2e-4 on the grad
norm (read: 5.8e-6, 9.3e-5). A param whose grad is mostly rounding can
move lr the other way at each of the two applied steps, and the CPU
convolutions' weight grads reduce in a thread-dependent order, so resnet's
params are held at 2e-3 on both sides (read: up to 6.4e-4). A planted
fault must miss the JAX losses by more than 1e-4 relative.

bf16 grads have their own row too. JAX reduces them in bf16 on the
sharded arrays, as the port's reduce-scatter does, each side in its own
order: the losses and grad norms hold the f32 limits, but a param whose
bf16 grad is mostly rounding can move lr the other way at each of the two
applied steps, so the params are held at 2e-3 against JAX and against
one process alike (read: 6.8e-4 on `embed/tokens`, both).
"""

from __future__ import annotations

import json
import math
import os
import socket
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import REGISTRY as JAX_REGISTRY
from polyaxon_tpu.parallel import build_mesh as jax_build_mesh
from polyaxon_tpu.train import data as jdata
from polyaxon_tpu.train import optimizers as jopt
from polyaxon_tpu.train.tasks import task_for as jtask_for
from polyaxon_tpu.train.trainer import Trainer as JaxTrainer
from polyaxon_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from polyaxon_tpu_torch.convert import params_from_jax
from polyaxon_tpu_torch.models import REGISTRY
from polyaxon_tpu_torch.models.transformer import flatten
from polyaxon_tpu_torch.parallel import ShardingRules
from polyaxon_tpu_torch.parallel.mesh import sharded_dim
from polyaxon_tpu_torch.runtime.builtin import build_trainer, run_builtin
from polyaxon_tpu_torch.train.checkpoint import CheckpointConfig, Checkpointer, read_step
from polyaxon_tpu_torch.train.tasks import LMTask

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "fixtures" / "torch_dist_worker.py"
WORLD = 2
STEPS = 3
LR = 1e-3
# (loss rtol, grad-norm rtol, final-param atol), against JAX and against
# the port's one process; resnet's own row (see the module docstring)
JAX_TOL = {"default": (1e-4, 1e-4, 3e-4), "resnet_data": (1e-4, 1e-3, 2e-3),
           "llama_fsdp_bf16": (1e-4, 1e-4, 2e-3)}
SELF_TOL = {"default": (2e-6, 2e-6, 1e-5), "resnet_data": (2e-5, 2e-4, 2e-3),
            "llama_fsdp_bf16": (2e-6, 2e-6, 2e-3)}
JAX_RTOL = JAX_TOL["default"][0]

BASE = {"steps": STEPS, "batch_size": 8, "learning_rate": LR, "warmup_steps": 1,
        "log_interval": 1, "platform": "cpu", "watchdog": False,
        "checkpoint": {"save_interval_steps": STEPS, "async_save": False}}
LM = {"seq_len": 32}
# name -> (model, parallelism, extra spec keys, f32)
RUNS = {
    "llama_data": ("llama-tiny", {"data": 2}, LM, False),
    "llama_fsdp": ("llama-tiny", {"fsdp": 2}, LM, False),
    # the llama recipes' bf16 grads: gathered, reduce-scattered and summed in bf16
    "llama_fsdp_bf16": ("llama-tiny", {"fsdp": 2}, {**LM, "grad_dtype": "bfloat16"}, False),
    # both axes at once, on a group of four: shards reduce-scattered over
    # fsdp, then summed over data
    "llama_hybrid": ("llama-tiny", {"data": 2, "fsdp": 2}, LM, False),
    "llama_data_mb": ("llama-tiny", {"data": 2}, {**LM, "microbatches": 2}, False),
    "bert_data": ("bert-tiny", {"data": 2}, {**LM, "microbatches": 2}, False),
    "resnet_data": ("resnet18-cifar", {"data": 2}, {}, True),
}
# planted fault -> the run it breaks
FAULTS = {"mlm_rank_mean": "bert_data", "bn_rank_stats": "resnet_data",
          "rank_local_microbatches": "bert_data"}
LLAMA_TASK = LMTask(REGISTRY["llama-tiny"][1])


def _world(name: str) -> int:
    return math.prod(RUNS[name][1].values())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_cfg(model: str, f32: bool):
    family, cfg = JAX_REGISTRY[model]
    return family, (replace(cfg, dtype=jnp.float32) if f32 else cfg)


def _jax_run(name: str):
    """The JAX Trainer on a 2-device mesh: (init params, extra, per-step
    metrics, final params, final extra), as numpy."""
    model, para, extra, f32 = RUNS[name]
    family, cfg = _jax_cfg(model, f32)
    spec = {**BASE, **extra}
    seq = spec.get("seq_len", 1)
    mesh = jax_build_mesh(para, devices=jax.devices()[:_world(name)])
    task = jtask_for(family, cfg)
    logged = []
    trainer = JaxTrainer(
        JaxTrainerConfig(model=cfg, batch_size=spec["batch_size"], seq_len=seq,
                         microbatches=spec.get("microbatches", 1), log_interval=1,
                         parallelism=para, grad_dtype=spec.get("grad_dtype"),
                         optimizer=jopt.OptimizerConfig(learning_rate=LR, warmup_steps=1,
                                                        total_steps=STEPS)),
        mesh=mesh, task=task, track=lambda i, m: logged.append(m))
    state = trainer.init_state(seed=0)
    init = jax.tree.map(np.asarray, (state.params, state.extra))
    kind = "synthetic-mlm" if family == "mlm" else (
        "synthetic-image" if family in ("vit", "resnet") else "synthetic-lm")
    dcfg = jdata.DataConfig(kind=kind, batch_size=spec["batch_size"], seq_len=seq,
                            vocab_size=getattr(cfg, "vocab_size", 32000), image_size=32,
                            num_classes=getattr(cfg, "num_classes", 1000), seed=0)
    state, _ = trainer.fit(jdata.make_batches(dcfg, mesh), num_steps=STEPS, state=state)
    final = jax.tree.map(np.asarray, (state.params, state.extra))
    return init, [{"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
                  for m in logged], final


def _fork_dir(root: Path, name: str, init) -> str:
    """A port checkpoint of the JAX init, for ``fork_from``."""
    path = root / "fork" / name
    ckpt = Checkpointer(CheckpointConfig(directory=str(path), async_save=False))
    params = params_from_jax(init[0], device="cpu")
    extra = None if init[1] is None else params_from_jax(init[1], device="cpu")
    ckpt.maybe_save(0, {"params": params, "opt_state": {}, "step": 0, "extra": extra},
                    force=True)
    ckpt.wait()
    return str(path)


def _spec(name: str, fork: str) -> dict:
    model, para, extra, _ = RUNS[name]
    return {**BASE, **extra, "model": model, "parallelism": para,
            "fork_from": {"path": fork}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case: the JAX runs, the port's one-process runs, a 2-rank
    group running the port's cases and a 4-rank one for the hybrid mesh;
    returns (JAX results, one-process results, case dir by name, the
    2-rank workers' stdout by rank)."""
    root = tmp_path_factory.mktemp("dist")
    jax_results, forks = {}, {}
    for name in RUNS:
        jax_results[name] = _jax_run(name)
        forks[name] = _fork_dir(root, name, jax_results[name][0])
    cases = [{"name": name, "spec": _spec(name, forks[name]), "f32": RUNS[name][3]}
             for name in RUNS if _world(name) == WORLD]
    cases += [{"name": f"fault_{fault}", "spec": _spec(run, forks[run]), "fault": fault,
               "f32": RUNS[run][3]} for fault, run in FAULTS.items()]
    vit = {**BASE, "model": "vit-tiny", "parallelism": {"data": 2}}
    cases.append({"name": "nan", "nan": {"rank": 1, "step": 1}, "spec": vit})
    # a transient NaN with no skip budget: both ranks roll back to step 2
    cases.append({"name": "rollback", "nan": {"rank": 1, "step": 2, "once": True},
                  "spec": {**vit, "steps": 4, "anomaly_skip_budget": 1,
                           "checkpoint": {"save_interval_steps": 1, "async_save": False}}})
    # a constant schedule, so that the first leg's (steps 2) lr is the
    # uninterrupted run's
    fsdp = {**_spec("llama_fsdp", forks["llama_fsdp"]), "schedule": "constant"}
    cases.append({"name": "resume", "runs": [{**fsdp, "steps": 2}, fsdp]})
    cases.append({"name": "resume_ref", "spec": fsdp})
    restore = {k: v for k, v in fsdp.items() if k != "fork_from"}
    cases.append({"name": "restore_shards", "restore_shards": True, "spec": restore})
    out = root / "cases"
    # a world-1 run writes the step-2 checkpoint the sharded restore reads
    _one_process(out / "restore_shards", {**fsdp, "parallelism": None, "steps": 2})
    stdout = _group(root, out, WORLD, cases)
    _group(root, out, 4, [{"name": name, "spec": _spec(name, forks[name])}
                          for name in RUNS if _world(name) == 4])
    # the port on one process, from the same init and batches
    single = {}
    for name in RUNS:
        art = root / "single" / name
        logged = _one_process(art, {**_spec(name, forks[name]), "parallelism": None},
                              f32=RUNS[name][3])
        single[name] = {"logged": logged, "params": _final_params(art)}
    return jax_results, single, out, stdout


def _group(root: Path, out: Path, world: int, cases: list) -> list:
    """One gloo group of ``world`` worker processes running ``cases``;
    returns each rank's output."""
    plan = root / f"plan{world}.json"
    plan.write_text(json.dumps({"world": world, "port": _free_port(), "out": str(out),
                                "timeout_s": 120, "cases": cases}))
    env = {k: v for k, v in os.environ.items() if not k.startswith("PLX_")}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2", JAX_PLATFORMS="cpu")
    logs = [root / f"worker{world}-{r}.log" for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(plan), str(r)], env=env,
                              stdout=open(logs[r], "w"), stderr=subprocess.STDOUT)
             for r in range(world)]
    try:
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    stdout = [log.read_text() for log in logs]
    assert codes == [0] * world, stdout
    return stdout


def _one_process(art: Path, spec: dict, f32: bool = False) -> list:
    """``run_builtin`` in this process, with ``art`` as its artifacts
    directory; returns the logged loss and grad norm of each step."""
    art.mkdir(parents=True)
    model = spec["model"]
    logged = []
    saved = REGISTRY[model]
    if f32:
        REGISTRY[model] = (saved[0], replace(saved[1], dtype=torch.float32))
    before = os.environ.get("PLX_ARTIFACTS_PATH")
    os.environ["PLX_ARTIFACTS_PATH"] = str(art)
    try:
        run_builtin(spec, track=lambda i, m: logged.append(
            {"loss": m["loss"], "grad_norm": m["grad_norm"]}))
    finally:
        REGISTRY[model] = saved
        if before is None:
            os.environ.pop("PLX_ARTIFACTS_PATH", None)
        else:
            os.environ["PLX_ARTIFACTS_PATH"] = before
    return logged


def _final_params(case_dir: Path) -> dict:
    state = read_step(case_dir / "outputs" / "checkpoints" / str(STEPS))
    return {"/".join(p): t.numpy() for p, t in flatten(state["params"])}


def _rank(case_dir: Path, rank: int) -> dict:
    return json.loads((case_dir / f"rank{rank}.json").read_text())


def _curve(logged, key):
    return np.array([m[key] for m in logged])


@pytest.mark.parametrize("name", sorted(RUNS))
def test_two_ranks_match_the_jax_mesh(runs, name):
    jax_results, _, out, _ = runs
    _, jlogged, (jparams, _) = jax_results[name]
    loss_tol, norm_tol, param_tol = JAX_TOL.get(name, JAX_TOL["default"])
    for rank in range(_world(name)):
        logged = _rank(out / name, rank)["logged"]
        np.testing.assert_allclose(_curve(logged, "loss"), _curve(jlogged, "loss"),
                                   rtol=loss_tol)
        np.testing.assert_allclose(_curve(logged, "grad_norm"),
                                   _curve(jlogged, "grad_norm"), rtol=norm_tol)
    jflat = {"/".join(p): np.asarray(v) for p, v in flatten(jparams)}
    for path, value in _final_params(out / name).items():
        np.testing.assert_allclose(value, jflat[path], atol=param_tol, err_msg=path)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_two_ranks_match_one_process(runs, name):
    _, single, out, _ = runs
    loss_tol, norm_tol, param_tol = SELF_TOL.get(name, SELF_TOL["default"])
    logged = _rank(out / name, 0)["logged"]
    for key, tol in (("loss", loss_tol), ("grad_norm", norm_tol)):
        np.testing.assert_allclose(_curve(logged, key), _curve(single[name]["logged"], key),
                                   rtol=tol)
    for path, value in _final_params(out / name).items():
        np.testing.assert_allclose(value, single[name]["params"][path],
                                   atol=param_tol, err_msg=path)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_planted_fault_fails_the_jax_comparison(runs, fault):
    jax_results, _, out, _ = runs
    jlogged = jax_results[FAULTS[fault]][1]
    logged = _rank(out / f"fault_{fault}", 0)["logged"]
    rel = np.abs(_curve(logged, "loss") / _curve(jlogged, "loss") - 1).max()
    assert rel > JAX_RTOL, f"{fault} went unseen: losses within {rel:.2e}"


def test_a_nan_in_one_ranks_batch_skips_the_step_on_both(runs):
    _, _, out, _ = runs
    for rank in range(WORLD):
        summary = _rank(out / "nan", rank)["summary"]
        assert summary["train_anomalies_loss"] == 1, summary
        assert summary["processes"] == WORLD
    state = read_step(out / "nan" / "outputs" / "checkpoints" / str(STEPS))
    assert state["opt_state"]["count"] == STEPS - 1  # the skipped step froze it


def test_a_transient_nan_rolls_both_ranks_back_together(runs):
    _, _, out, _ = runs
    logged = []
    for rank in range(WORLD):
        result = _rank(out / "rollback", rank)
        summary = result["summary"]
        assert summary["train_rollbacks"] == 1 and summary["train_anomalies_loss"] == 1
        logged.append(result["logged"])
    # the replayed step 2 and step 3 are logged once each, alike on both ranks
    assert [m["step"] for m in logged[0]] == [0, 1, 2, 3] and logged[0] == logged[1]
    assert all(np.isfinite(m["loss"]) for m in logged[0])


def test_fsdp_checkpoint_restores_at_world_one_bit_equal(runs):
    _, _, out, _ = runs
    case = out / "llama_fsdp"
    saved = read_step(case / "outputs" / "checkpoints" / str(STEPS))
    spec = {k: v for k, v in _spec("llama_fsdp", "unused").items()
            if k not in ("parallelism", "fork_from")}
    trainer, _ = build_trainer(spec, artifacts_dir=str(case))
    state, step = trainer.restore_or_init()
    assert step == STEPS
    for (path, t), (_, s) in zip(flatten(state.params), flatten(saved["params"])):
        assert torch.equal(t, s), path
    for t, s in zip(state.opt_state.mu, saved["opt_state"]["mu"]):
        assert torch.equal(t, s)
    assert state.opt_state.count == saved["opt_state"]["count"] == STEPS


def test_a_world_one_step_restores_into_fsdp_shards(runs):
    """Each rank holds its half of every embed-sharded leaf of the params
    and the Adam moments (JAX's device r holds block r), bit-equal to the
    world-1 checkpoint's leaves."""
    _, _, out, _ = runs
    case = out / "restore_shards"
    full = read_step(case / "outputs" / "checkpoints" / "2")
    specs = [s for _, s in flatten(LLAMA_TASK.param_specs(ShardingRules()))]
    leaves, dims = {}, {}
    for i, (path, t) in enumerate(flatten(full["params"])):
        for key, value in (("params/" + "/".join(path), t),
                           (f"mu/{i}", full["opt_state"]["mu"][i]),
                           (f"nu/{i}", full["opt_state"]["nu"][i])):
            leaves[key], dims[key] = value, sharded_dim(specs[i])
    halved = 0
    for rank in range(WORLD):
        meta = _rank(case, rank)
        assert meta["restored_step"] == 2 and meta["fsdp_index"] == rank
        shards = torch.load(case / f"rank{rank}.pt", weights_only=True)
        assert set(shards) == set(leaves)
        for key, shard in shards.items():
            whole, dim = leaves[key], dims[key]
            if dim is None:
                assert torch.equal(shard, whole), key
                continue
            n = whole.shape[dim] // WORLD
            assert shard.shape[dim] == n, key
            assert torch.equal(shard, whole.narrow(dim, rank * n, n)), key
            halved += 1
    assert halved == 2 * 3 * 9  # ranks x (params, mu, nu) x llama-tiny's embed leaves


def test_an_fsdp_run_resumes_where_it_stopped(runs):
    _, _, out, _ = runs
    for rank in range(WORLD):
        resumed = _rank(out / "resume", rank)
        uninterrupted = _rank(out / "resume_ref", rank)["logged"]
        assert resumed["summary"]["resumed_from_step"] == 2
        # both legs' steps, the resumed one bit-equal
        assert resumed["logged"] == uninterrupted


def test_only_rank_zero_writes_the_run(runs):
    from polyaxon_tpu_torch.tracking import read_events

    _, _, out, stdout = runs
    case = out / "llama_data"
    assert [e.step for e in read_events(str(case), "metric", "loss")] == list(range(STEPS))
    assert (case / "outputs" / "final.json").exists()
    # every 2-rank run: RUNS', the faults, nan, rollback, the resume's two
    # legs and its reference
    runs_of_two = sum(1 for name in RUNS if _world(name) == WORLD)
    assert stdout[0].count('{"final"') == runs_of_two + len(FAULTS) + 5
    assert '{"final"' not in stdout[1] and '{"step"' not in stdout[1]
