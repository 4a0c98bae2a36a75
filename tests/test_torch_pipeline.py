"""The port's GPipe trunk over ``stage`` ranks (``parallel/pipeline.py``)
on gloo groups, against the JAX package's pipeline on CPU meshes of the
same shape.

A group of two worker processes (``tests/fixtures/torch_dist_worker.py``,
one thread each) and one of four run every case while this process runs
the JAX side:

- trunks: one forward and backward of ``mean(hidden^2) + 0.01 * balance``
  over llama-tiny ``{stage: 2}`` under each gate (``none``, ``full``,
  ``inner``) and with ``pp_remat_ticks``, ``{stage: 2, model: 2}``,
  ``{stage: 2, context: 2}`` (ring) and llama-moe-tiny ``{stage: 2,
  expert: 2}`` (a2a) against JAX's ``apply_hidden`` on the mesh: each
  rank's hidden rows and chunk, the loss, and each rank's block of every
  leaf's grad;
- training: two steps of llama-tiny ``{stage: 2}`` and ``{stage: 2,
  data: 2}``, of a hidden-128 llama with adafactor and of llama-tiny with
  a user rule that removes ``wi``'s stage cut (the whole stack stored on
  each stage, each stage reading its layers) under ``{stage: 2}``, and of
  vit-tiny ``{stage: 2}`` through ``run_builtin`` from the JAX init against
  the JAX ``Trainer`` on the same mesh: losses, grad norms, final params,
  and the first step's grads on every rank (the stage-replicated
  embedding, final norm and head carry the stage-free run's grad on every
  stage rank);
- three planted faults in the schedule (a tick's microbatch index off by
  one, the stages' output cotangents summed, the trunk input's cotangent
  left on stage 0) must each fail that comparison;
- a checkpoint saved at ``{stage: 2}`` restores at world 1 bit-equal;
- the tools over the groups: ``scripts/ring_bench.py``'s ring and gather
  paths over the 2-rank ring equal the loopback ring's on the same inputs,
  and ``scripts/pp_bench.py`` at ``{stage: 2, model: 2}`` (one step of its
  widened llama-tiny from the JAX init) gives both gates a loss within
  1e-6 of each other and 1e-5 relative of JAX's ``apply_hidden(...).mean()``
  on a 4-device mesh of the same shape, and every rank's grad blocks
  within 1e-5 of each leaf's largest |grad| of JAX's.

In this process: an inactive layer body emits exact zeros and an active
one equals the ungated body (ROADMAP C1), and the refusals (``full`` with
collectives, ``stage`` with ``expert`` under capacity dispatch, layers or
a batch that do not divide, a ResNet under ``stage``) carry the JAX
package's errors.

Tolerances, those of ``tests/test_torch_tp_cp.py``: f32 sums in other
orders; losses and grad norms 1e-4 relative over three AdamW steps, final
params 3e-4 absolute; the forward 3e-5 absolute and 1e-4 relative; a
grad block within 1e-4 relative and 2e-5 of the leaf's largest |grad|
(the one-process MoE parity reads 8e-6 of it). The gates' trunks agree
to 1e-6 relative and the grads to JAX's own gate test's 2e-5 / 2e-6.
A fault fails when its loss, grad norm, param or grad reading misses
JAX's by more than these limits.
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
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP
from torch_threads import one_torch_thread  # noqa: F401

from polyaxon_tpu.models import REGISTRY as JAX_REGISTRY
from polyaxon_tpu.models import transformer as jt
from polyaxon_tpu.parallel import build_mesh as jax_build_mesh
from polyaxon_tpu.train import data as jdata
from polyaxon_tpu.train import optimizers as jopt
from polyaxon_tpu.train.tasks import task_for as jtask_for
from polyaxon_tpu.train.trainer import Trainer as JaxTrainer
from polyaxon_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from polyaxon_tpu_torch.convert import params_from_jax
from polyaxon_tpu_torch.models import REGISTRY
from polyaxon_tpu_torch.models import transformer as tt
from polyaxon_tpu_torch.models.transformer import flatten
from polyaxon_tpu_torch.parallel import pipeline
from polyaxon_tpu_torch.ops.ring_attention import LoopbackRing
from polyaxon_tpu_torch.parallel.mesh import Mesh, normalize_axis_sizes
from polyaxon_tpu_torch.runtime.builtin import build_trainer
from polyaxon_tpu_torch.scripts import ring_bench as rb
from polyaxon_tpu_torch.train.checkpoint import CheckpointConfig, Checkpointer, read_step
from polyaxon_tpu_torch.train.tasks import refuse_unsupported_axes
from polyaxon_tpu_torch.train.trainer import Trainer, TrainerConfig

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "fixtures" / "torch_dist_worker.py"
STEPS = 2
LR = 1e-3
JAX_TOL = (1e-4, 1e-4, 3e-4)       # loss rtol, grad-norm rtol, final-param atol
FORWARD_TOL = (3e-5, 1e-4)         # atol, rtol
GRAD_TOL = (1e-4, 2e-5)            # rtol, atol as a share of the leaf's largest |grad|
GATE_TOL = (1e-6, 2e-5, 2e-6)      # loss rtol, grad rtol, grad atol
BATCH, SEQ = 8, 16
BASE = {"steps": STEPS, "batch_size": BATCH, "seq_len": 32, "learning_rate": LR,
        "warmup_steps": 1, "log_interval": 1, "platform": "cpu", "watchdog": False,
        "checkpoint": {"save_interval_steps": STEPS, "async_save": False}}
# name -> (model, parallelism, runtime keys, config changes); two steps,
# the first step's grads captured on every rank
TRAIN = {
    "stage2": ("llama-tiny", {"stage": 2}, {}, {}),
    "stage2_data2": ("llama-tiny", {"stage": 2, "data": 2}, {}, {}),
    # adafactor over the stages' layer blocks (a hidden-128 tree factors;
    # at 50x AdamW's rate its RMS-scaled step moves the params as far)
    "stage2_adafactor": ("llama-tiny", {"stage": 2},
                         {"optimizer": "adafactor", "learning_rate": 50 * LR},
                         {"hidden": 128, "mlp_dim": 128}),
    # a user rule that removes wi's layers -> stage cut: each stage reads
    # its own layers' block of the whole stack
    "stage2_rule": ("llama-tiny", {"stage": 2},
                    {"partition_rules": [["layers/mlp/wi$", [None, "fsdp", "model"]]]}, {}),
    # ROADMAP R1's ViT pipeline
    "vit_stage2": ("vit-tiny", {"stage": 2}, {}, {}),
}
FAULTS = ("pp_microbatch_off_by_one", "pp_sum_cotangents", "pp_embed_stage0_only")
# name -> (model, parallelism, config changes); one forward and backward
TRUNKS = {
    "gate_none": ("llama-tiny", {"stage": 2}, {"pp_gate": "none"}),
    "gate_full": ("llama-tiny", {"stage": 2}, {"pp_gate": "full"}),
    "gate_inner": ("llama-tiny", {"stage": 2}, {"pp_gate": "inner"}),
    "remat_off": ("llama-tiny", {"stage": 2}, {"pp_microbatches": 4}),
    "remat_ticks": ("llama-tiny", {"stage": 2}, {"pp_microbatches": 4,
                                                 "pp_remat_ticks": True}),
    "model2": ("llama-tiny", {"stage": 2, "model": 2}, {}),
    "context2": ("llama-tiny", {"stage": 2, "context": 2}, {"seq_parallel": "ring"}),
    "expert2": ("llama-moe-tiny", {"stage": 2, "expert": 2}, {"moe_dispatch": "a2a"}),
}
# the tools over the groups: ring_bench's inputs (one row of 4 heads, D 64,
# over the 2-rank ring: one 512-row chunk, one flash block, a rank) and
# pp_bench's mesh at 4 ranks; its widened llama-tiny is scripts/pp_bench.py's
RING_BENCH_SHAPE = (1, 4, 1024, 64)
PP_BENCH_MESH = {"stage": 2, "model": 2}
PP_BENCH_CFG = dict(hidden=256, num_heads=8, num_kv_heads=8, mlp_dim=1024, num_layers=4,
                    max_seq=128, pp_microbatches=2)
PP_BENCH_TOL = (1e-6, 1e-5, 1e-5)  # gates' losses abs, loss vs JAX rel, grad of leaf max
#: scripts/pp_bench.py:71-81: a gate's keys and the last line's
PP_BENCH_KEYS = ({"gate", "step_ms", "loss"}, {"gated_over_ungated", "bubble_fraction", "note"})
# the trunks JAX computes (the gates and the remat pair share {stage: 2}'s)
JAX_TRUNK = {"gate_none": "gate_none", "gate_full": "gate_none", "gate_inner": "gate_none",
             "remat_off": "gate_none", "remat_ticks": "gate_none", "model2": "model2",
             "context2": "context2", "expert2": "expert2"}


def _world(para: dict) -> int:
    return math.prod(para.values())


def _free_ports(n: int) -> list:
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _start_group(root: Path, out: Path, world: int, port: int, cases: list) -> tuple:
    plan = root / f"plan{world}.json"
    plan.write_text(json.dumps({"world": world, "port": port, "out": str(out),
                                "timeout_s": 120, "cases": cases}))
    env = {k: v for k, v in os.environ.items() if not k.startswith("PLX_")}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    logs = [root / f"worker{world}-{r}.log" for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(plan), str(r)], env=env,
                              stdout=open(logs[r], "w"), stderr=subprocess.STDOUT)
             for r in range(world)]
    return procs, logs


def _join(procs: list, logs: list) -> None:
    try:
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert codes == [0] * len(procs), [log.read_text()[-4000:] for log in logs]


def _jax_params(model: str, seed: int = 0) -> dict:
    return jax.tree.map(np.asarray, jt.init(jax.random.PRNGKey(seed), JAX_REGISTRY[model][1]))


def _jax_init(model: str, changes: dict) -> dict:
    """The params of the JAX Trainer's ``init_state(seed=0)`` for ``model``
    with the config ``changes``: the task's init from key 0."""
    family, cfg = JAX_REGISTRY[model]
    params, _ = jtask_for(family, replace(cfg, **changes)).init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _flat(tree) -> dict:
    return {"/".join(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_trunk(name: str, params, tokens) -> tuple:
    """JAX's hidden states, loss and grads of ``mean(hidden^2) + 0.01 *
    balance`` on the case's mesh."""
    model, para, changes = TRUNKS[name]
    cfg = replace(JAX_REGISTRY[model][1], **changes)
    mesh = jax_build_mesh(para, devices=jax.devices()[:_world(para)])

    def loss(p, toks):
        h, aux = jt.apply_hidden(p, toks, cfg, mesh=mesh, return_aux=True)
        return (h.astype(jnp.float32) ** 2).mean() + cfg.router_aux_coef * aux[0], h

    toks = jax.device_put(jnp.asarray(tokens),
                          NamedSharding(mesh, JP(("data", "fsdp", "expert"), "context")))
    (value, hidden), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, params), toks)
    return np.asarray(hidden), float(value), _flat(grads)


def _jax_pp_bench(params, tokens) -> tuple:
    """The JAX script's loss, ``apply_hidden(...).mean()``, and its grads on
    a mesh of PP_BENCH_MESH's shape."""
    cfg = replace(JAX_REGISTRY["llama-tiny"][1], **PP_BENCH_CFG)
    mesh = jax_build_mesh(PP_BENCH_MESH, devices=jax.devices()[:_world(PP_BENCH_MESH)])
    toks = jnp.asarray(tokens)

    def loss(p):
        return jt.apply_hidden(p, toks, cfg, mesh=mesh).astype(jnp.float32).mean()

    value, grads = jax.jit(jax.value_and_grad(loss))(jax.tree.map(jnp.asarray, params))
    return float(value), _flat(grads)


def _ring_inputs() -> dict:
    rng = np.random.default_rng(5)
    return {n: (rng.standard_normal(RING_BENCH_SHAPE) * 0.1).astype(np.float32)
            for n in ("q", "k", "v")}


def _jax_train(name: str, init) -> tuple:
    """The JAX Trainer on the case's mesh from ``init``: per-step metrics,
    final params and the first step's grads (the task loss's on the first
    batch), as numpy."""
    model, para, keys, changes = TRAIN[name]
    family, cfg = JAX_REGISTRY[model]
    cfg = replace(cfg, **changes)
    mesh = jax_build_mesh(para, devices=jax.devices()[:_world(para)])
    logged = []
    ocfg = jopt.OptimizerConfig(name=keys.get("optimizer", "adamw"),
                                learning_rate=keys.get("learning_rate", LR), warmup_steps=1,
                                total_steps=STEPS)
    trainer = JaxTrainer(
        JaxTrainerConfig(model=cfg, batch_size=BASE["batch_size"], seq_len=BASE["seq_len"],
                         log_interval=1, parallelism=para, optimizer=ocfg),
        mesh=mesh, task=jtask_for(family, cfg), track=lambda i, m: logged.append(m),
        partition_rules=keys.get("partition_rules"))
    state = trainer.init_state_from(jax.tree.map(jnp.asarray, init))
    kind = "synthetic-image" if family == "vit" else "synthetic-lm"
    dcfg = jdata.DataConfig(kind=kind, batch_size=BASE["batch_size"],
                            seq_len=BASE["seq_len"], vocab_size=getattr(cfg, "vocab_size", 1),
                            image_size=getattr(cfg, "image_size", 32),
                            num_classes=getattr(cfg, "num_classes", 1000), seed=0)
    batch = next(iter(jdata.make_batches(dcfg, mesh)))
    task = trainer.task
    grads = jax.jit(jax.grad(lambda p: task.loss(p, None, batch, mesh=mesh)[0]))(
        state.params)
    state, _ = trainer.fit(jdata.make_batches(dcfg, mesh), num_steps=STEPS, state=state)
    return ([{"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])} for m in logged],
            _flat(state.params), _flat(grads))


def _fork_dir(root: Path, init, name: str = "fork") -> str:
    path = root / name
    ckpt = Checkpointer(CheckpointConfig(directory=str(path), async_save=False))
    ckpt.maybe_save(0, {"params": params_from_jax(init, device="cpu"), "opt_state": {},
                        "step": 0, "extra": None}, force=True)
    ckpt.wait()
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case: the two gloo groups run in the background while this
    process runs the JAX side. Returns (JAX trunks, JAX training runs, the
    case dir root, the trunk tokens)."""
    root = tmp_path_factory.mktemp("pipeline")
    out = root / "cases"
    tokens = np.random.default_rng(1).integers(0, 256, (BATCH, SEQ)).astype(np.int32)
    np.save(root / "tokens.npy", tokens)
    params = {m: _jax_params(m) for m in ("llama-tiny", "llama-moe-tiny")}
    for m, p in params.items():
        torch.save(params_from_jax(p, device="cpu"), root / f"{m}.pt")
    # each training case's init and its port checkpoint, for fork_from
    inits, forks = {}, {}
    for name, (model, _, _, changes) in TRAIN.items():
        inits[name] = _jax_init(model, changes)
        forks[name] = _fork_dir(root, inits[name], f"fork-{name}")
    cases = {2: [], 4: []}
    for name, (model, para, changes) in TRUNKS.items():
        cases[_world(para)].append({
            "name": name, "grads": True, "cfg": changes, "params": str(root / f"{model}.pt"),
            "tokens": str(root / "tokens.npy"),
            "spec": {"model": model, "parallelism": para}})
    for name, (model, para, keys, changes) in TRAIN.items():
        base = BASE if model.startswith("llama") else {k: v for k, v in BASE.items()
                                                     if k != "seq_len"}
        cases[_world(para)].append({
            "name": name, "capture_grads": True, "model_cfg": changes,
            "spec": {**base, **keys, "model": model, "parallelism": para,
                     "fork_from": {"path": forks[name]}}})
    for fault in FAULTS:
        cases[2].append({"name": fault, "fault": fault, "capture_grads": True,
                         "spec": {**BASE, "model": "llama-tiny", "parallelism": {"stage": 2},
                                  "fork_from": {"path": forks["stage2"]}}})
    np.savez(root / "ring_inputs.npz", **_ring_inputs())
    cases[2].append({"name": "ring_bench", "ring_bench": True,
                     "inputs": str(root / "ring_inputs.npz"), "seq": RING_BENCH_SHAPE[2]})
    pp_cfg = replace(JAX_REGISTRY["llama-tiny"][1], **PP_BENCH_CFG)
    pp_params = jax.tree.map(np.asarray, jt.init(jax.random.PRNGKey(0), pp_cfg))
    pp_tokens = np.random.default_rng(1).integers(0, pp_cfg.vocab_size, (8, 128))
    torch.save(params_from_jax(pp_params, device="cpu"), root / "pp_params.pt")
    np.save(root / "pp_tokens.npy", pp_tokens)
    cases[4].append({"name": "pp_bench", "pp_bench": True,
                     "params": str(root / "pp_params.pt"),
                     "tokens": str(root / "pp_tokens.npy")})
    ports = _free_ports(2)
    groups = [_start_group(root, out, w, port, cases[w]) for w, port in zip((2, 4), ports)]
    try:
        trunks = {name: _jax_trunk(name, params[TRUNKS[name][0]], tokens)
                  for name in set(JAX_TRUNK.values())}
        trunks["pp_bench"] = _jax_pp_bench(pp_params, pp_tokens)
        trains = {name: _jax_train(name, inits[name]) for name in TRAIN}
    finally:
        for procs, logs in groups:
            _join(procs, logs)
    return trunks, trains, out, tokens


def _rank_files(case_dir: Path) -> list:
    n = len(list(case_dir.glob("rank*.json")))
    return [json.loads((case_dir / f"rank{r}.json").read_text()) for r in range(n)]


def _block(full: np.ndarray, cuts: list, coords: dict, sizes: dict) -> np.ndarray:
    """This rank's block of a full leaf under its cuts."""
    for axis, dim in cuts:
        n = full.shape[dim] // sizes[axis]
        full = np.take(full, range(coords[axis] * n, (coords[axis] + 1) * n), axis=dim)
    return full


def _grad_misses(got: dict, cuts: dict, coords: dict, sizes: dict, want: dict) -> float:
    """The worst grad block reading against JAX's, as a multiple of
    GRAD_TOL (> 1: the comparison fails)."""
    rtol, atol_share = GRAD_TOL
    worst = 0.0
    for path, g in got.items():
        if path.endswith("attn/bk"):
            continue  # a key bias's exact grad is zero: its relative error is noise
        ref = _block(want[path], cuts[path], coords, sizes)
        atol = atol_share * np.abs(want[path]).max() + 1e-30
        err = np.abs(np.asarray(g, np.float64) - ref) / (atol + rtol * np.abs(ref))
        worst = max(worst, float(err.max()))
    return worst


def _sizes(para: dict) -> dict:
    return normalize_axis_sizes(para)


@pytest.mark.parametrize("name", sorted(TRUNKS))
def test_pipelined_trunks_match_the_jax_mesh(runs, name):
    trunks, _, out, _ = runs
    jhidden, jloss, jgrads = trunks[JAX_TRUNK[name]]
    para = TRUNKS[name][1]
    for rank, meta in enumerate(_rank_files(out / name)):
        saved = torch.load(out / name / f"rank{rank}.pt", weights_only=True)
        (r0, r1), (c0, c1) = meta["rows"], meta["cols"]
        np.testing.assert_allclose(saved["hidden"].numpy(), jhidden[r0:r1, c0:c1],
                                   atol=FORWARD_TOL[0], rtol=FORWARD_TOL[1])
        np.testing.assert_allclose(meta["loss"], jloss, rtol=JAX_TOL[0])
        worst = _grad_misses({k: v.numpy() for k, v in saved["grads"].items()},
                             saved["cuts"], meta["coords"], _sizes(para), jgrads)
        assert worst <= 1, f"rank {rank}: a grad block misses JAX's by {worst:.3g}x"


def test_the_gates_give_equal_trunks(runs):
    _, _, out, _ = runs
    ref = torch.load(out / "gate_none" / "rank0.pt", weights_only=True)
    ref_loss = _rank_files(out / "gate_none")[0]["loss"]
    for name in ("gate_full", "gate_inner"):
        for rank, meta in enumerate(_rank_files(out / name)):
            got = torch.load(out / name / f"rank{rank}.pt", weights_only=True)
            ref_r = torch.load(out / "gate_none" / f"rank{rank}.pt", weights_only=True)
            np.testing.assert_allclose(meta["loss"], ref_loss, rtol=GATE_TOL[0])
            assert torch.equal(got["hidden"], ref_r["hidden"]), name
            for path, g in got["grads"].items():
                np.testing.assert_allclose(g.numpy(), ref_r["grads"][path].numpy(),
                                           rtol=GATE_TOL[1], atol=GATE_TOL[2],
                                           err_msg=f"{name} {path}")
    assert ref["aux"].abs().max() == 0  # a dense trunk's aux


def test_remat_ticks_keeps_the_loss_and_saves_less(runs):
    """Each tick keeps only its stage input (recomputing the stage forward
    in the backward): the same loss and grads, and a fraction of what
    autograd saves (counted with saved_tensors_hooks)."""
    _, _, out, _ = runs
    for rank in range(2):
        off = _rank_files(out / "remat_off")[rank]
        on = _rank_files(out / "remat_ticks")[rank]
        assert on["loss"] == off["loss"]
        assert on["saved_bytes"] < 0.5 * off["saved_bytes"], (on, off)
        a = torch.load(out / "remat_off" / f"rank{rank}.pt", weights_only=True)
        b = torch.load(out / "remat_ticks" / f"rank{rank}.pt", weights_only=True)
        for path, g in a["grads"].items():
            assert torch.equal(g, b["grads"][path]), path


def _train_misses(case_dir: Path, name: str, trains: dict) -> float:
    """The worst reading of a training case against the JAX Trainer's
    (losses and grad norms of every rank, rank 0's final params, every
    rank's first-step grads), as a multiple of its tolerance."""
    jlogged, jparams, jgrads = trains[name]
    loss_tol, norm_tol, param_tol = JAX_TOL
    para = TRAIN[name][1]
    worst = 0.0
    for rank, meta in enumerate(_rank_files(case_dir)):
        logged = meta["logged"]
        for key, tol in (("loss", loss_tol), ("grad_norm", norm_tol)):
            got = np.array([m[key] for m in logged])
            want = np.array([m[key] for m in jlogged])
            worst = max(worst, float(np.abs(got / want - 1).max() / tol))
        cap = torch.load(case_dir / f"grads{rank}.pt", weights_only=True)
        worst = max(worst, _grad_misses({k: v.numpy() for k, v in cap["grads"].items()},
                                        cap["cuts"], cap["coords"], _sizes(para), jgrads))
    state = read_step(case_dir / "outputs" / "checkpoints" / str(STEPS))
    for path, t in flatten(state["params"]):
        key = "/".join(path)
        worst = max(worst, float(np.abs(t.numpy() - jparams[key]).max() / param_tol))
    return worst


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_pipelined_training_matches_the_jax_trainer(runs, name):
    _, trains, out, _ = runs
    worst = _train_misses(out / name, name, trains)
    assert worst <= 1, f"{name}: a reading misses JAX's by {worst:.3g}x its tolerance"


def test_stage_replicated_leaves_hold_the_stage_free_grad_on_every_stage(runs):
    """The embedding, final norm and head are computed on every stage
    rank: each holds the whole leaf's grad, the same on every stage."""
    _, trains, out, _ = runs
    jgrads = trains["stage2"][2]
    caps = [torch.load(out / "stage2" / f"grads{r}.pt", weights_only=True) for r in range(2)]
    for path in ("embed/tokens", "final_norm/scale", "lm_head/w"):
        assert caps[0]["cuts"][path] == caps[1]["cuts"][path] == []
        assert torch.equal(caps[0]["grads"][path], caps[1]["grads"][path]), path
        np.testing.assert_allclose(caps[1]["grads"][path].numpy(), jgrads[path],
                                   rtol=GRAD_TOL[0],
                                   atol=GRAD_TOL[1] * np.abs(jgrads[path]).max())


def test_a_rule_that_removes_the_stage_cut_stores_the_whole_stack(runs):
    """``stage2_rule``'s ``wi`` is stored whole on each stage (the rule's
    spec) and read as the stage's layers: its first-step grad is the whole
    stack's on both stages, gathered over them, the same on each."""
    _, _, out, _ = runs
    caps = [torch.load(out / "stage2_rule" / f"grads{r}.pt", weights_only=True)
            for r in range(2)]
    layers = REGISTRY["llama-tiny"][1].num_layers
    assert caps[0]["cuts"]["layers/mlp/wi"] == caps[1]["cuts"]["layers/mlp/wi"] == []
    assert caps[0]["cuts"]["layers/mlp/wo"] == [["stage", 0]]
    assert caps[0]["grads"]["layers/mlp/wi"].shape[0] == layers
    assert torch.equal(caps[0]["grads"]["layers/mlp/wi"], caps[1]["grads"]["layers/mlp/wi"])


@pytest.mark.parametrize("fault", FAULTS)
def test_each_pipeline_planted_fault_fails_the_jax_comparison(runs, fault):
    _, trains, out, _ = runs
    worst = _train_misses(out / fault, "stage2", trains)
    assert worst > 1, f"{fault} went unseen: within {worst:.3g} of the tolerances"


def test_a_stage_checkpoint_restores_at_world_one_bit_equal(runs):
    _, _, out, _ = runs
    case = out / "stage2"
    saved = read_step(case / "outputs" / "checkpoints" / str(STEPS))
    trainer, _ = build_trainer({**BASE, "model": "llama-tiny"}, artifacts_dir=str(case))
    state, step = trainer.restore_or_init()
    assert step == STEPS
    for (path, t), (_, s) in zip(flatten(state.params), flatten(saved["params"])):
        assert torch.equal(t, s), path
    # the whole stack, both stages' layers
    assert state.params["layers"]["attn"]["wq"].shape[0] == \
        REGISTRY["llama-tiny"][1].num_layers
    for name in ("mu", "nu"):
        for t, s in zip(getattr(state.opt_state, name), saved["opt_state"][name]):
            assert torch.equal(t, s)


# -- the tools over the groups -----------------------------------------------------


def test_ring_bench_over_a_two_rank_ring_equals_the_loopback(runs):
    """Each rank's chunk of the ring path and of the gather path (K and V
    all-gathered over the group) equals the loopback ring's on the same
    inputs; the tool's line counts the group's two ranks."""
    _, _, out, _ = runs
    q, k, v = (torch.from_numpy(a) for a in _ring_inputs().values())
    loop = LoopbackRing(2)
    want = {"ring": rb.ring_forward(q, k, v, loop), "gather": rb.gather_forward(q, k, v, loop)}
    for rank, meta in enumerate(_rank_files(out / "ring_bench")):
        saved = torch.load(out / "ring_bench" / f"rank{rank}.pt", weights_only=True)
        c0, c1 = meta["chunk"]
        for path, ref in want.items():
            assert torch.equal(saved[path], ref[:, :, c0:c1]), (rank, path)
        (row,) = meta["rows"]
        assert (row["ranks"], row["cp"], row["platform"]) == (2, 2, "cpu")


@pytest.mark.parametrize("gate", ["none", "auto"])
def test_pp_bench_matches_the_jax_pipeline(runs, gate):
    """scripts/pp_bench.py's loss and grads under each gate against JAX's on
    the same mesh shape: the loss within PP_BENCH_TOL, every rank's block of
    every leaf's grad within 1e-5 of the leaf's largest |grad| (a pipeline
    is compared leaf by leaf, ROADMAP C2)."""
    trunks, _, out, _ = runs
    jloss, jgrads = trunks["pp_bench"]
    gates_abs, loss_rel, grad_share = PP_BENCH_TOL
    sizes = _sizes(PP_BENCH_MESH)
    for rank, meta in enumerate(_rank_files(out / "pp_bench")):
        lines = {line["gate"]: line for line in meta["lines"]}
        assert abs(lines["none"]["loss"] - lines["auto"]["loss"]) < gates_abs
        np.testing.assert_allclose(lines[gate]["loss"], jloss, rtol=loss_rel)
        grads = torch.load(out / "pp_bench" / f"rank{rank}.pt", weights_only=True)[gate]
        assert set(grads) == set(jgrads)
        for path, g in grads.items():
            want = _block(jgrads[path], meta["cuts"][path], meta["coords"], sizes)
            err = float(np.abs(g.numpy().astype(np.float64) - want).max())
            assert err <= grad_share * np.abs(jgrads[path]).max(), (rank, path, err)


def test_pp_bench_lines_carry_the_jax_keys(runs):
    """The JAX script's keys, with the gate ``auto`` resolved to beside
    each gate's line and the mesh beside the last: ``inner`` under model,
    and the bubble (S-1)/(M+S-1) = 1/3 at two stages and two microbatches."""
    _, _, out, _ = runs
    meta = _rank_files(out / "pp_bench")[0]
    gate_keys, last_keys = PP_BENCH_KEYS
    assert [line["gate"] for line in meta["lines"]] == ["none", "auto"]
    for line in meta["lines"]:
        assert set(line) == gate_keys | {"resolved_gate"}
    assert [line["resolved_gate"] for line in meta["lines"]] == ["none", "inner"]
    summary = meta["summary"]
    assert set(summary) == last_keys | {"mesh"}
    assert summary["mesh"] == PP_BENCH_MESH and summary["bubble_fraction"] == 1 / 3
    assert '"stage": 2, "model": 2' in summary["note"]


# -- in this process ---------------------------------------------------------------


def _layer_inputs(cfg, seed: int = 1):
    params = tt.init(cfg, seed=0, device="cpu")
    lp = tt._unstack(params["layers"], cfg.num_layers)[0]
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (2, 16, cfg.hidden)).astype(np.float32)).to(cfg.dtype)
    return lp, x


@pytest.mark.parametrize("model", ["llama-tiny-bias", "llama-moe-tiny"])
def test_an_inactive_body_emits_exact_zeros_and_an_active_one_is_the_body(model):
    """ROADMAP C1's rule for the port (the JAX package's
    test_bubble_tick_emits_exact_zeros_with_bias): with nonzero biases, an
    inactive tick's layer output and aux are exactly zero, and an active
    tick equals the ungated body bit for bit."""
    if model == "llama-tiny-bias":
        cfg = replace(REGISTRY["llama-tiny"][1], use_bias=True, norm="ln", act="gelu",
                      pos="none", num_layers=1)
    else:
        cfg = REGISTRY[model][1]
    lp, x = _layer_inputs(cfg)
    if cfg.use_bias:
        for leaf in (lp["mlp"]["bo"], lp["mlp"]["bi"], lp["attn"]["bo"]):
            leaf.fill_(1.0)
    tables = None
    if cfg.pos == "rope":
        from polyaxon_tpu_torch.ops.layers import rope_frequencies

        cos, sin = rope_frequencies(cfg.hd, cfg.max_seq, cfg.rope_theta)
        tables = (cos[:16], sin[:16])
    inner = tt.InnerAxes()
    out, aux = tt._layer_body(x, lp, cfg, tables, None, inner, False)
    assert torch.all(out == 0) and torch.all(aux == 0)
    on, aux_on = tt._layer_body(x, lp, cfg, tables, None, inner, True)
    ref, aux_ref = tt._layer_body(x, lp, cfg, tables, None, inner, None)
    assert torch.equal(on, ref) and torch.equal(aux_on, aux_ref)
    assert ref.abs().max() > 0


def _fake_mesh(**axes) -> Mesh:
    """A mesh's sizes without a process group behind it: what run_trunk
    reads before its first collective."""
    return Mesh(sizes=normalize_axis_sizes(axes), rank=0, distributed=True)


def _trunk_args(model: str, **changes):
    cfg = replace(REGISTRY[model][1], **changes)
    params = tt.init(cfg, seed=0, device="cpu")
    return torch.zeros(8, 16, cfg.hidden), params["layers"], cfg


@pytest.mark.parametrize("model,axes,changes,match", [
    # the JAX package's own errors (models/transformer.py, parallel/pipeline.py)
    ("llama-tiny", {"stage": 2, "model": 2}, {"pp_gate": "full"}, "unsound"),
    ("llama-moe-tiny", {"stage": 2, "expert": 2}, {}, "needs moe_dispatch='a2a'"),
    ("llama-moe-tiny", {"stage": 2, "expert": 3},
     {"moe_dispatch": "a2a", "num_experts": 4}, "not divisible by expert"),
    ("llama-tiny", {"stage": 2}, {"pp_microbatches": 3}, "not divisible by 3 pipeline"),
])
def test_the_pipeline_path_raises_the_jax_errors(model, axes, changes, match):
    x, layers, cfg = _trunk_args(model, **changes)
    with pytest.raises(ValueError, match=match):
        tt.run_trunk(x, layers, cfg, mesh=_fake_mesh(**axes))


def test_layers_that_do_not_divide_over_the_stages_raise():
    x, layers, cfg = _trunk_args("llama-tiny")
    three = {k: {n: torch.cat([t, t[:1]]) for n, t in v.items()} for k, v in layers.items()}
    with pytest.raises(ValueError, match="3 layers do not divide over 2 stages"):
        pipeline.gpipe_trunk(x, three, lambda xl, lp: (xl, None), _fake_mesh(stage=2),
                             num_layers=3)
    with pytest.raises(ValueError, match="2 layers do not divide over 3 stages"):
        refuse_unsupported_axes(REGISTRY["llama-tiny"][1], normalize_axis_sizes({"stage": 3}))


def test_a_resnet_under_stage_raises_trunk():
    cfg = REGISTRY["resnet18-cifar"][1]
    with pytest.raises(NotImplementedError, match="trunk"):
        Trainer(TrainerConfig(model=cfg, batch_size=8, seq_len=1, parallelism={"stage": 2}),
                device="cpu")


def test_one_stage_runs_the_plain_trunk():
    x, layers, cfg = _trunk_args("llama-tiny", pos="none")
    mesh = _fake_mesh()
    got = pipeline.gpipe_trunk(x, layers, lambda xl, lp: tt._scan_layers(xl, lp, cfg), mesh)
    ref = tt._scan_layers(x, layers, cfg)
    assert torch.equal(got[0], ref[0])
