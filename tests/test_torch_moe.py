"""The port's mixture-of-experts layer (``models/transformer.py``: the
router, the capacity plan, the gather dispatch and combine, the streamed
capacity dispatch, all-to-all and the dense oracle) against the JAX
package's, on llama-moe-tiny with the same numpy-seeded inputs and the
JAX init's weights (``params_from_jax``).

In this process, in f32:
- the routing (top_idx, gates), the plan's tables (token for slot, slot,
  keep) and the drop fraction equal JAX's exactly, at cf 0.5 (drops) and
  at ample capacity; a router with tied logits picks the experts
  ``jax.lax.top_k`` picks (lowest index first);
- dense, capacity, streamed capacity (cap blocks 1, 3 and 4, with drops)
  and all-to-all (one rank): hidden states, aux and every leaf's grad of
  ``mean(hidden^2) + 0.01 * balance``;
- aux is 1.0 at perfect balance and high when collapsed; ``LMTask`` adds
  it to the loss as JAX's does; param counts, the param tree and the
  specs are JAX's; the errors (MoE with biases, experts that do not
  divide over ``expert``, an unknown dispatch) are JAX's.

On gloo groups (``tests/fixtures/torch_dist_worker.py``, one thread a
rank), against JAX on CPU meshes of the same shape, with drops:
- capacity under ``{data: 2}``: the plan over the whole batch (each rank
  keeps its rows), the global balance and drop fraction;
- all-to-all under ``{expert: 2}``: the plan local to each rank's tokens,
  each rank's two experts;
- two training steps of ``{expert: 2, data: 2}`` (capacity at cf 0.5: the
  experts gathered where the layer runs, drops at every step) through
  ``run_builtin`` against the JAX ``Trainer``: losses, grad norms, router
  drop fractions, final params and every rank's first-step grads.

Tolerances (those of ``tests/test_torch_tp_cp.py`` and
``tests/test_torch_pipeline.py``): the forward 3e-5 absolute and 1e-4
relative; a grad within 1e-4 relative and 2e-5 of the leaf's largest
|grad| (a one-process reading: 8e-6 of it); losses and grad norms 1e-4
relative; final params 3e-4 absolute after AdamW steps at lr 1e-3. Drop
fractions are counts of int plans and must be equal.
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

from polyaxon_tpu.models import REGISTRY as JAX_REGISTRY
from polyaxon_tpu.models import transformer as jt
from polyaxon_tpu.parallel import build_mesh as jax_build_mesh
from polyaxon_tpu.train import data as jdata
from polyaxon_tpu.train import optimizers as jopt
from polyaxon_tpu.train.tasks import LMTask as JaxLMTask
from polyaxon_tpu.train.trainer import Trainer as JaxTrainer
from polyaxon_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from polyaxon_tpu_torch.convert import params_from_jax
from polyaxon_tpu_torch.models import REGISTRY
from polyaxon_tpu_torch.models import transformer as tt
from polyaxon_tpu_torch.models.transformer import flatten, unflatten
from polyaxon_tpu_torch.parallel import ShardingRules
from polyaxon_tpu_torch.parallel.mesh import normalize_axis_sizes
from polyaxon_tpu_torch.train.checkpoint import CheckpointConfig, Checkpointer, read_step
from polyaxon_tpu_torch.train.tasks import LMTask, refuse_unsupported_axes

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "fixtures" / "torch_dist_worker.py"
MODEL = "llama-moe-tiny"
JCFG, TCFG = JAX_REGISTRY[MODEL][1], REGISTRY[MODEL][1]
FORWARD_TOL = (3e-5, 1e-4)         # atol, rtol
GRAD_TOL = (1e-4, 2e-5)            # rtol, atol as a share of the leaf's largest |grad|
JAX_TOL = (1e-4, 1e-4, 3e-4)       # loss rtol, grad-norm rtol, final-param atol
STEPS, LR = 2, 1e-3
AMPLE = float(JCFG.num_experts) / JCFG.expert_top_k
# the routed cases: dispatch, capacity factor, cap block
DISPATCHES = {
    "dense": ("dense", 1.25, 0),
    "capacity_ample": ("capacity", AMPLE, 0),
    "capacity_drops": ("capacity", 0.5, 0),
    "streamed_1": ("capacity", 0.5, 1),
    "streamed_3": ("capacity", 0.5, 3),
    "streamed_4": ("capacity", 0.5, 4),
    "a2a_drops": ("a2a", 0.5, 0),
}
# gloo cases: name -> (parallelism, config changes)
MESH_CASES = {"capacity_data2": ({"data": 2}, {"expert_capacity_factor": 0.5}),
              "a2a_expert2": ({"expert": 2}, {"moe_dispatch": "a2a",
                                              "expert_capacity_factor": 0.5})}
TRAIN_PARA = {"expert": 2, "data": 2}
TRAIN_CFG = {"expert_capacity_factor": 0.5}   # drops at every step
TRAIN_BASE = {"steps": STEPS, "batch_size": 8, "seq_len": 32, "learning_rate": LR,
              "warmup_steps": 1, "log_interval": 1, "platform": "cpu", "watchdog": False,
              "checkpoint": {"save_interval_steps": STEPS, "async_save": False}}


def _params(seed: int = 0) -> dict:
    return jax.tree.map(np.asarray, jt.init(jax.random.PRNGKey(seed), JCFG))


def _tokens(shape=(2, 16), seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, JCFG.vocab_size, shape).astype(np.int32)


def _flat(tree) -> dict:
    return {"/".join(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_run(params, tokens, cfg, mesh=None) -> tuple:
    """JAX's hidden states, aux, loss and grads of ``mean(hidden^2) +
    coef * balance``."""
    def loss(p, toks):
        h, aux = jt.apply_hidden(p, toks, cfg, mesh=mesh, return_aux=True)
        return (h.astype(jnp.float32) ** 2).mean() + cfg.router_aux_coef * aux[0], (h, aux)

    toks = jnp.asarray(tokens)
    if mesh is not None:
        toks = jax.device_put(toks, NamedSharding(
            mesh, JP(("data", "fsdp", "expert"), "context")))
    (value, (h, aux)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, params), toks)
    return np.asarray(h), np.asarray(aux), float(value), _flat(grads)


def _port_run(params, tokens, cfg) -> tuple:
    paths, leaves = zip(*flatten(params_from_jax(params, device="cpu")))
    diff = [t.requires_grad_() for t in leaves]
    h, aux = tt.apply_hidden(unflatten(paths, diff), torch.from_numpy(tokens).long(), cfg,
                             return_aux=True)
    loss = (h.float() ** 2).mean() + cfg.router_aux_coef * aux[0]
    grads = torch.autograd.grad(loss, diff, allow_unused=True, materialize_grads=True)
    return (h.detach().numpy(), aux.detach().numpy(), loss.item(),
            {"/".join(p): g.numpy() for p, g in zip(paths, grads)})


def _assert_grads(got: dict, want: dict, err: str = "") -> None:
    for path, g in want.items():
        np.testing.assert_allclose(got[path], g, rtol=GRAD_TOL[0],
                                   atol=GRAD_TOL[1] * np.abs(g).max(), err_msg=f"{err} {path}")


def _y_and_router(seed: int = 3):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((2, 16, JCFG.hidden)).astype(np.float32)
    router = np.array(_params()["layers"]["mlp"]["router"][0])
    return y, router


def _jax_route(y, router, k: int):
    """The JAX layer's routing (``_moe_mlp``'s route_fn lines)."""
    logits = jnp.einsum("bsh,he->bse", jnp.asarray(y, jnp.float32), jnp.asarray(router))
    top_vals, top_idx = jax.lax.top_k(logits, k)
    return np.asarray(top_idx), np.asarray(jax.nn.softmax(top_vals, axis=-1))


# -- the plan and the router -----------------------------------------------------------


@pytest.mark.parametrize("cf", [0.5, AMPLE])
def test_plan_tables_equal_jax_exactly(cf):
    y, router = _y_and_router()
    E, k = JCFG.num_experts, JCFG.expert_top_k
    T = y.shape[0] * y.shape[1]
    cap = max(int(T * k / E * cf), 1)
    jidx, jgates = _jax_route(y, router, k)
    tidx, tgates, _ = tt._route(torch.from_numpy(y), torch.from_numpy(router), E, k)
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    np.testing.assert_allclose(tgates.numpy(), jgates, rtol=1e-6, atol=1e-7)
    jt_tables = jt._dispatch_tables(jnp.asarray(jidx.reshape(T, k)),
                                    jnp.asarray(jgates.reshape(T, k)), E, k, cap)
    tt_tables = tt._dispatch_tables(tidx.reshape(T, k), tgates.reshape(T, k), E, k, cap)
    for name, j, t in zip(("tfs", "slot", "keep"), jt_tables[:3], tt_tables[:3]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    assert float(tt_tables[3]) == float(jt_tables[3])
    assert (float(tt_tables[3]) > 0) == (cf < 1)


def test_router_ties_pick_the_lowest_index_first():
    """A zero router ties every expert: ``jax.lax.top_k`` picks 0..k-1;
    so must the port. Random small-integer logits tie often."""
    E, k = JCFG.num_experts, JCFG.expert_top_k
    y, _ = _y_and_router()
    tidx, _, _ = tt._route(torch.from_numpy(y), torch.zeros(JCFG.hidden, E), E, k)
    assert (tidx.numpy() == np.arange(k)).all()
    logits = np.random.default_rng(5).integers(0, 3, (256, 8)).astype(np.float32)
    for kk in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(logits), kk)
        tv, ti = tt._top_k(torch.from_numpy(logits), kk)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("name", sorted(DISPATCHES))
def test_dispatches_match_jax(name):
    dispatch, cf, cb = DISPATCHES[name]
    changes = dict(moe_dispatch=dispatch, expert_capacity_factor=cf, moe_cap_block=cb)
    params, tokens = _params(), _tokens()
    jh, jaux, jloss, jgrads = _jax_run(params, tokens, replace(JCFG, **changes))
    th, taux, tloss, tgrads = _port_run(params, tokens, replace(TCFG, **changes))
    np.testing.assert_allclose(th, jh, atol=FORWARD_TOL[0], rtol=FORWARD_TOL[1])
    np.testing.assert_allclose(taux[0], jaux[0], rtol=1e-6)
    assert taux[1] == jaux[1]
    assert (taux[1] > 0) == (cf < 1 and dispatch != "dense")
    np.testing.assert_allclose(tloss, jloss, rtol=1e-6)
    _assert_grads(tgrads, jgrads, name)


def test_aux_is_one_at_perfect_balance():
    params = params_from_jax(_params(), device="cpu")
    params["layers"]["mlp"]["router"].zero_()
    _, aux = tt.apply_hidden(params, torch.from_numpy(_tokens()).long(), TCFG,
                             return_aux=True)
    assert float(aux[0]) == pytest.approx(1.0, abs=1e-3)


def test_collapsed_router_has_high_aux():
    """Inputs that make expert 0 win every token (the JAX package's case,
    on the same weights)."""
    E, h, m = JCFG.num_experts, JCFG.hidden, JCFG.mlp_dim
    rng = np.random.default_rng(0)
    mp = {"router": np.zeros((h, E), np.float32),
          **{n: (rng.standard_normal(s) * 0.02).astype(np.float32)
             for n, s in (("wi", (E, h, m)), ("wg", (E, h, m)), ("wo", (E, m, h)))}}
    mp["router"][:, 0] = 1.0
    y = np.abs(rng.standard_normal((2, 16, h))).astype(np.float32)
    _, jaux = jt._moe_mlp(jnp.asarray(y), jax.tree.map(jnp.asarray, mp), JCFG)
    _, taux = tt._moe_mlp(torch.from_numpy(y), params_from_jax(mp, device="cpu"), TCFG)
    assert float(taux[0]) > 1.5
    np.testing.assert_allclose(taux.numpy(), np.asarray(jaux), rtol=1e-6)


def test_lm_task_adds_aux_as_jax_does():
    params = _params()
    batch = {"inputs": _tokens(), "labels": _tokens(seed=2)}
    jloss, jmetrics, _ = JaxLMTask(JCFG).loss(jax.tree.map(jnp.asarray, params), None,
                                              jax.tree.map(jnp.asarray, batch))
    tloss, tmetrics, _ = LMTask(TCFG).loss(
        params_from_jax(params, device="cpu"), None,
        {k: torch.from_numpy(v).long() for k, v in batch.items()})
    assert float(tloss) > float(tmetrics["loss"])  # aux on top
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
    for key in ("loss", "router_aux", "router_drop_frac"):
        np.testing.assert_allclose(float(tmetrics[key]), float(jmetrics[key]), rtol=1e-6,
                                   err_msg=key)


# -- counts, trees and errors ------------------------------------------------------------


@pytest.mark.parametrize("model", ["llama-moe-tiny", "llama-moe-1b", "mixtral-8x7b"])
def test_param_counts_match_jax(model):
    cfg, jcfg = REGISTRY[model][1], JAX_REGISTRY[model][1]
    assert cfg.num_params() == jcfg.num_params()
    assert cfg.active_params() == jcfg.active_params() < cfg.num_params()
    assert cfg.flops_per_token(2048) == jcfg.flops_per_token(2048)


def test_moe_param_tree_and_specs_match_jax():
    def leaves(tree):
        return {"/".join(k.key for k in path): v for path, v in
                jax.tree_util.tree_flatten_with_path(tree, is_leaf=jt._is_leaf)[0]}

    jab = leaves(jt.abstract_params(JCFG))
    tab = {"/".join(p): v for p, v in flatten(tt.abstract_params(TCFG))}
    assert jab.keys() == tab.keys()
    for path, (shape, axes) in jab.items():
        assert tab[path] == (shape, axes), path
    assert tab["layers/mlp/wi"][1][1] == "expert"
    jspecs = {"/".join(k.key for k in path): tuple(v) for path, v in
              jax.tree_util.tree_flatten_with_path(
                  jt.param_specs(JCFG), is_leaf=lambda x: isinstance(x, JP))[0]}
    tspecs = {"/".join(p): tuple(v) for p, v in flatten(tt.param_specs(TCFG, ShardingRules()))}
    assert jspecs == tspecs


def test_moe_with_bias_raises():
    with pytest.raises(ValueError, match="MoE layers do not support use_bias") as theirs:
        jt.abstract_params(replace(JCFG, use_bias=True))
    with pytest.raises(ValueError, match="MoE layers do not support use_bias") as ours:
        tt.abstract_params(replace(TCFG, use_bias=True))
    assert str(theirs.value) == str(ours.value)


def test_indivisible_experts_raise_the_jax_error():
    """a2a with 6 experts over an expert axis of 4 (the JAX package's
    test_a2a_rejects_indivisible_experts)."""
    jcfg = replace(JCFG, num_experts=6, moe_dispatch="a2a")
    params = jt.init(jax.random.PRNGKey(0), jcfg)
    mesh = jax_build_mesh({"expert": 4, "data": 2}, devices=jax.devices())
    with pytest.raises(ValueError, match="not divisible") as theirs:
        jt.apply(params, jnp.asarray(_tokens((8, 16))), jcfg, mesh=mesh)
    with pytest.raises(ValueError, match="not divisible") as ours:
        refuse_unsupported_axes(replace(TCFG, num_experts=6, moe_dispatch="a2a"),
                                normalize_axis_sizes({"expert": 4, "data": 2}))
    assert str(theirs.value) == str(ours.value)


def test_an_unknown_dispatch_raises_the_jax_error():
    y, _ = _y_and_router()
    params = _params()
    mp = jax.tree.map(lambda t: t[0], params["layers"]["mlp"])
    with pytest.raises(ValueError, match="unknown moe_dispatch") as theirs:
        jt._moe_mlp(jnp.asarray(y), jax.tree.map(jnp.asarray, mp),
                    replace(JCFG, moe_dispatch="scatter"))
    with pytest.raises(ValueError, match="unknown moe_dispatch") as ours:
        tt._moe_mlp(torch.from_numpy(y), params_from_jax(mp, device="cpu"),
                    replace(TCFG, moe_dispatch="scatter"))
    assert str(theirs.value) == str(ours.value)


# -- gloo ranks against the JAX mesh ------------------------------------------------------


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


def _jax_train(init) -> tuple:
    """The JAX Trainer on ``{expert: 2, data: 2}``: per-step metrics,
    final params and the first step's grads."""
    mesh = jax_build_mesh(TRAIN_PARA, devices=jax.devices()[:_world(TRAIN_PARA)])
    cfg = replace(JCFG, **TRAIN_CFG)
    logged = []
    trainer = JaxTrainer(
        JaxTrainerConfig(model=cfg, batch_size=TRAIN_BASE["batch_size"],
                         seq_len=TRAIN_BASE["seq_len"], log_interval=1,
                         parallelism=TRAIN_PARA,
                         optimizer=jopt.OptimizerConfig(learning_rate=LR, warmup_steps=1,
                                                        total_steps=STEPS)),
        mesh=mesh, task=JaxLMTask(cfg), track=lambda i, m: logged.append(m))
    state = trainer.init_state_from(jax.tree.map(jnp.asarray, init))
    dcfg = jdata.DataConfig(kind="synthetic-lm", batch_size=TRAIN_BASE["batch_size"],
                            seq_len=TRAIN_BASE["seq_len"], vocab_size=JCFG.vocab_size, seed=0)
    batch = next(iter(jdata.make_batches(dcfg, mesh)))
    grads = jax.jit(jax.grad(lambda p: trainer.task.loss(p, None, batch, mesh=mesh)[0]))(
        state.params)
    state, _ = trainer.fit(jdata.make_batches(dcfg, mesh), num_steps=STEPS, state=state)
    return ([{k: float(m[k]) for k in ("loss", "grad_norm", "router_drop_frac")}
             for m in logged], _flat(state.params), _flat(grads))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The gloo groups (two ranks for the mesh cases, four for training)
    run in the background while this process runs JAX's side. Returns
    (JAX mesh results, JAX training, the case dir root, the tokens)."""
    root = tmp_path_factory.mktemp("moe")
    out = root / "cases"
    params = _params()
    tokens = _tokens((8, 16))
    np.save(root / "tokens.npy", tokens)
    torch.save(params_from_jax(params, device="cpu"), root / "params.pt")
    fork = root / "fork"
    ckpt = Checkpointer(CheckpointConfig(directory=str(fork), async_save=False))
    ckpt.maybe_save(0, {"params": params_from_jax(params, device="cpu"), "opt_state": {},
                        "step": 0, "extra": None}, force=True)
    ckpt.wait()
    cases2 = [{"name": name, "grads": True, "cfg": changes, "params": str(root / "params.pt"),
               "tokens": str(root / "tokens.npy"),
               "spec": {"model": MODEL, "parallelism": para}}
              for name, (para, changes) in MESH_CASES.items()]
    cases4 = [{"name": "train", "capture_grads": True, "model_cfg": TRAIN_CFG,
               "spec": {**TRAIN_BASE, "model": MODEL, "parallelism": TRAIN_PARA,
                        "fork_from": {"path": str(fork)}}}]
    ports = _free_ports(2)
    groups = [_start_group(root, out, 2, ports[0], cases2),
              _start_group(root, out, 4, ports[1], cases4)]
    try:
        mesh_results = {}
        for name, (para, changes) in MESH_CASES.items():
            mesh = jax_build_mesh(para, devices=jax.devices()[:_world(para)])
            mesh_results[name] = _jax_run(params, tokens, replace(JCFG, **changes), mesh)
        train = _jax_train(params)
    finally:
        for procs, logs in groups:
            _join(procs, logs)
    return mesh_results, train, out, tokens


def _block(full: np.ndarray, cuts: list, coords: dict, sizes: dict) -> np.ndarray:
    for axis, dim in cuts:
        n = full.shape[dim] // sizes[axis]
        full = np.take(full, range(coords[axis] * n, (coords[axis] + 1) * n), axis=dim)
    return full


def _rank_meta(case_dir: Path, rank: int) -> dict:
    return json.loads((case_dir / f"rank{rank}.json").read_text())


@pytest.mark.parametrize("name", sorted(MESH_CASES))
def test_moe_ranks_match_the_jax_mesh(ranks, name):
    """capacity_data2: the plan over the whole batch (drops and balance
    global, each rank its rows); a2a_expert2: the plan local to each rank,
    the drop fraction its ranks' mean, the balance global."""
    mesh_results, _, out, _ = ranks
    jh, jaux, jloss, jgrads = mesh_results[name]
    para = MESH_CASES[name][0]
    sizes = normalize_axis_sizes(para)
    drops = []
    for rank in range(_world(para)):
        meta = _rank_meta(out / name, rank)
        saved = torch.load(out / name / f"rank{rank}.pt", weights_only=True)
        (r0, r1), (c0, c1) = meta["rows"], meta["cols"]
        np.testing.assert_allclose(saved["hidden"].numpy(), jh[r0:r1, c0:c1],
                                   atol=FORWARD_TOL[0], rtol=FORWARD_TOL[1])
        np.testing.assert_allclose(float(saved["aux"][0]), jaux[0], rtol=1e-6)
        drops.append(float(saved["aux"][1]))
        np.testing.assert_allclose(meta["loss"], jloss, rtol=1e-6)
        for path, g in saved["grads"].items():
            want = _block(jgrads[path], saved["cuts"][path], meta["coords"], sizes)
            np.testing.assert_allclose(g.numpy(), want, rtol=GRAD_TOL[0],
                                       atol=GRAD_TOL[1] * np.abs(jgrads[path]).max(),
                                       err_msg=f"rank {rank} {path}")
    assert jaux[1] > 0
    assert np.mean(drops) == pytest.approx(float(jaux[1]), abs=1e-7)
    if name == "capacity_data2":
        assert drops[0] == drops[1]  # the whole batch's fraction on each rank


def test_expert_data_training_matches_the_jax_trainer(ranks):
    _, (jlogged, jparams, jgrads), out, _ = ranks
    case = out / "train"
    loss_tol, norm_tol, param_tol = JAX_TOL
    sizes = normalize_axis_sizes(TRAIN_PARA)
    for rank in range(_world(TRAIN_PARA)):
        logged = _rank_meta(case, rank)["logged"]
        for key, tol in (("loss", loss_tol), ("grad_norm", norm_tol)):
            np.testing.assert_allclose([m[key] for m in logged], [m[key] for m in jlogged],
                                       rtol=tol, err_msg=key)
        assert [m["router_drop_frac"] for m in logged] == pytest.approx(
            [m["router_drop_frac"] for m in jlogged], abs=1e-7)
        cap = torch.load(case / f"grads{rank}.pt", weights_only=True)
        assert cap["cuts"]["layers/mlp/wi"] == [["expert", 1]]
        for path, g in cap["grads"].items():
            want = _block(jgrads[path], cap["cuts"][path], cap["coords"], sizes)
            np.testing.assert_allclose(g.numpy(), want, rtol=GRAD_TOL[0],
                                       atol=GRAD_TOL[1] * np.abs(jgrads[path]).max(),
                                       err_msg=f"rank {rank} {path}")
    assert jlogged[0]["router_drop_frac"] > 0
    state = read_step(case / "outputs" / "checkpoints" / str(STEPS))
    for path, t in flatten(state["params"]):
        key = "/".join(path)
        np.testing.assert_allclose(t.numpy(), jparams[key], atol=param_tol, err_msg=key)
