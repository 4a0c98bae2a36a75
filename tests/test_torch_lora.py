"""The port's LoRA (``polyaxon_tpu_torch.partition.lora``) against the JAX
package's, in one process on the CPU, from the same weights (the JAX init
and JAX ``init_lora``'s adapters, carried across) and numpy-seeded data.

- target paths and adapter shapes are JAX's for llama-tiny, bert-tiny and
  llama-moe-tiny (an expert stack factored as fan-in E, fan-out h·mlp);
- ``merge_lora`` is JAX's (f32, within 1e-6 of each leaf's largest
  element) and ``b = 0`` is the identity bit for bit; a block's merge (the model axis' column and row
  blocks, the experts' blocks) is the whole merge's slice;
- three steps of llama-tiny and bert-tiny LoRA with adamw and with sgd at
  ``grad_clip`` 1e-3 (the clip active: it must read the adapters' own
  norm) against the JAX ``LoRATask`` + ``frozen_base_optimizer`` Trainer.
  Losses and ``grad_norm`` (base and adapters) agree within 1e-6
  relative — f32 sums in other orders, measured at 1.7e-7 — final
  adapters within 1e-5 absolute (measured 4e-7), and the base is bit-equal
  to its start in both. Two planted faults must fail that comparison: the
  clip by the whole tree's norm, and ``grad_norm`` over the adapters alone;
- ``{stage: 2}`` raises the JAX package's error;
- the builtin runtime with ``lora:`` (a ``{base, lora}`` checkpoint saved,
  restored and resumed bit-equal), ``import:`` with ``lora:`` (its step-0
  loss the plain import's, bit for bit), ``partition_rules:``, and a
  tracked run's ``partition_plan`` output against JAX's
  ``plan_summary_from_shardings``;
- C8: the first request to a ``llama-moe-tiny`` engine raises a
  ``ValueError`` in both packages.
"""

from __future__ import annotations

import json
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import REGISTRY as JAX_REGISTRY
from polyaxon_tpu.parallel import build_mesh as jax_build_mesh
from polyaxon_tpu.partition import lora as jlora
from polyaxon_tpu.partition import plan_summary_from_shardings as jax_plan_summary
from polyaxon_tpu.train import data as jdata
from polyaxon_tpu.train import optimizers as jopt
from polyaxon_tpu.train.tasks import task_for as jtask_for
from polyaxon_tpu.train.trainer import Trainer as JaxTrainer
from polyaxon_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from polyaxon_tpu_torch.convert import params_from_jax
from polyaxon_tpu_torch.models import REGISTRY
from polyaxon_tpu_torch.parallel.mesh import Mesh
from polyaxon_tpu_torch.partition import lora as tlora
from polyaxon_tpu_torch.partition import plan_summary_from_shardings
from polyaxon_tpu_torch.partition.rules import tree_paths
from polyaxon_tpu_torch.runtime.builtin import build_trainer, run_builtin
from polyaxon_tpu_torch.train import data as tdata
from polyaxon_tpu_torch.train import optimizers as topt
from polyaxon_tpu_torch.train.checkpoint import read_step
from polyaxon_tpu_torch.train.tasks import task_for
from polyaxon_tpu_torch.train.trainer import Trainer, TrainerConfig

STEPS = 3
LORA = dict(rank=4, alpha=8.0)
LOSS_RTOL = NORM_RTOL = 1e-6
ADAPTER_ATOL = 1e-5
# adamw at lr 1e-2; sgd at lr 1 so that the clipped (1e-3) adapter steps
# move the adapters well past ADAPTER_ATOL
OPTIMIZERS = {"adamw": dict(name="adamw", learning_rate=1e-2),
              "sgd": dict(name="sgd", learning_rate=1.0, grad_clip=1e-3)}
RUNS = [(m, o) for m in ("llama-tiny", "bert-tiny") for o in OPTIMIZERS]
FAULTS = {"clip_by_whole_tree_norm": ("llama-tiny", "sgd"),
          "grad_norm_over_adapters_only": ("llama-tiny", "adamw")}
BUILTIN = {"model": "llama-tiny", "platform": "cpu", "batch_size": 8, "seq_len": 16,
           "log_interval": 1, "watchdog": False, "learning_rate": 1e-2, "warmup_steps": 1,
           "lora": {"rank": 4, "alpha": 8.0}}


def _ocfg(opt: str) -> dict:
    return dict(OPTIMIZERS[opt], warmup_steps=1, total_steps=STEPS)


def _data_cfg(family: str, vocab: int) -> dict:
    return dict(kind="synthetic-mlm" if family == "mlm" else "synthetic-lm", batch_size=8,
                seq_len=16, vocab_size=vocab, seed=0)


def _flat(tree) -> dict:
    return {p: np.asarray(v) for p, v in tree_paths(tree)}


@pytest.fixture(scope="module")
def inits():
    """model -> the JAX init's {base, lora} as numpy (adapters from JAX's
    init_lora)."""
    out = {}
    for model in ("llama-tiny", "bert-tiny"):
        family, cfg = JAX_REGISTRY[model]
        trainer = JaxTrainer(JaxTrainerConfig(model=cfg, batch_size=8, seq_len=16),
                             mesh=jax_build_mesh({"data": 1}, devices=jax.devices()[:1]),
                             task=jtask_for(family, cfg))
        base = trainer.init_state(seed=0).params
        lora = jlora.init_lora(jax.random.PRNGKey(1), base, jlora.LoRAConfig(**LORA))
        out[model] = jax.tree.map(np.asarray, {"base": base, "lora": lora})
    return out


def _jax_run(model: str, opt: str, init) -> tuple:
    family, cfg = JAX_REGISTRY[model]
    lcfg = jlora.LoRAConfig(**LORA)
    ocfg = jopt.OptimizerConfig(**_ocfg(opt))
    mesh = jax_build_mesh({"data": 1}, devices=jax.devices()[:1])
    logged = []
    trainer = JaxTrainer(
        JaxTrainerConfig(model=cfg, batch_size=8, seq_len=16, log_interval=1, optimizer=ocfg),
        mesh=mesh, task=jlora.LoRATask(jtask_for(family, cfg), lcfg),
        tx=jlora.frozen_base_optimizer(jopt.make_optimizer(ocfg)),
        track=lambda i, m: logged.append((float(m["loss"]), float(m["grad_norm"]))))
    state = trainer.init_state_from(jax.tree.map(jnp.asarray, init))
    state, _ = trainer.fit(jdata.make_batches(jdata.DataConfig(**_data_cfg(family,
                                                                           cfg.vocab_size)),
                                              mesh), num_steps=STEPS, state=state)
    return np.array(logged), _flat(jax.tree.map(np.asarray, state.params))


def _port_run(model: str, opt: str, init) -> tuple:
    family, cfg = REGISTRY[model]
    ocfg = topt.OptimizerConfig(**_ocfg(opt))
    logged = []
    trainer = Trainer(
        TrainerConfig(model=cfg, batch_size=8, seq_len=16, log_interval=1, optimizer=ocfg),
        device="cpu", task=tlora.LoRATask(task_for(family, cfg), tlora.LoRAConfig(**LORA)),
        tx=tlora.FrozenBaseOptimizer(topt.make_optimizer(ocfg)),
        track=lambda i, m: logged.append((m["loss"], m["grad_norm"])))
    state = trainer.init_state_from(params_from_jax(init, device="cpu"))
    state, _ = trainer.fit(tdata.make_batches(tdata.DataConfig(**_data_cfg(family,
                                                                           cfg.vocab_size))),
                           num_steps=STEPS, state=state)
    return np.array(logged), {p: t.numpy() for p, t in tree_paths(state.params)}


@pytest.fixture(scope="module")
def jax_runs(inits):
    needed = set(RUNS) | set(FAULTS.values())
    return {run: _jax_run(*run, inits[run[0]]) for run in needed}


def _misses(logged, params, jlogged, jparams) -> float:
    """The worst reading against JAX's as a multiple of its tolerance."""
    rel = np.abs(logged / jlogged - 1)
    worst = max(rel[:, 0].max() / LOSS_RTOL, rel[:, 1].max() / NORM_RTOL)
    for path, value in params.items():
        if path.startswith("lora/"):
            worst = max(worst, np.abs(value - jparams[path]).max() / ADAPTER_ATOL)
    return float(worst)


# -- shapes and the merge ----------------------------------------------------------------

TARGETS = [("llama-tiny", None), ("llama-tiny", r"lm_head/w$|attn/wk$"),
           ("bert-tiny", None), ("llama-moe-tiny", r"mlp/(wi|wg)$"),
           ("llama-moe-tiny", r"attn/wo$|mlp/wo$")]


@pytest.mark.parametrize("model,target", TARGETS)
def test_target_paths_and_adapter_shapes_are_the_jax_packages(model, target):
    from polyaxon_tpu.partition import abstract_params_for as jabstract
    from polyaxon_tpu_torch.partition import abstract_params_for

    kw = dict(LORA, **({"target": target} if target else {}))
    jbase, tbase = jabstract(model), abstract_params_for(model)
    assert tlora.target_paths(tbase, tlora.LoRAConfig(**kw)) == \
        jlora.target_paths(jbase, jlora.LoRAConfig(**kw))
    jshapes = [(p, tuple(x.shape), str(np.dtype(x.dtype))) for p, x in tree_paths(
        jax.eval_shape(lambda k: jlora.init_lora(k, jbase, jlora.LoRAConfig(**kw)),
                       jax.ShapeDtypeStruct((2,), "uint32")))]
    tshapes = [(p, tuple(x.shape), str(x.dtype).removeprefix("torch."))
               for p, x in tree_paths(tlora.init_lora(tbase, tlora.LoRAConfig(**kw),
                                                      device="meta"))]
    assert tshapes == jshapes
    if model == "llama-moe-tiny" and target == r"mlp/(wi|wg)$":
        assert dict((p, s) for p, s, _ in tshapes)["layers/mlp/wi/b"] == (2, 4, 64 * 64)


@pytest.mark.parametrize("target", ["attn/nope$", "attn_norm/scale$", "attn/(wq", "embed/"])
def test_bad_targets_raise_what_the_jax_package_raises(target):
    from polyaxon_tpu.partition import abstract_params_for as jabstract
    from polyaxon_tpu_torch.partition import abstract_params_for

    with pytest.raises(jlora.LoRATargetError) as want:
        jlora.target_paths(jabstract("llama-tiny"), jlora.LoRAConfig(target=target))
    with pytest.raises(tlora.LoRATargetError) as got:
        tlora.target_paths(abstract_params_for("llama-tiny"), tlora.LoRAConfig(target=target))
    assert str(got.value) == str(want.value)


def _random_adapters(base, target=None, seed=0):
    """JAX's adapter tree over ``base`` with a and b drawn from numpy."""
    kw = dict(LORA, **({"target": target} if target else {}))
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jlora.init_lora(k, base, jlora.LoRAConfig(**kw)),
                            jax.ShapeDtypeStruct((2,), "uint32"))
    return jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32) * 0.1,
                        shapes), kw


@pytest.mark.parametrize("model,target", TARGETS)
def test_merge_lora_is_the_jax_packages(model, target):
    family, cfg = JAX_REGISTRY[model]
    base = jax.tree.map(np.asarray, jtask_for(family, cfg).init(jax.random.PRNGKey(0))[0])
    adapters, kw = _random_adapters(base, target)
    want = _flat(jax.tree.map(np.asarray, jlora.merge_lora(base, adapters,
                                                           jlora.LoRAConfig(**kw))))
    tbase = params_from_jax(base, device="cpu")
    got = _flat(tlora.merge_lora(tbase, params_from_jax(adapters, device="cpu"),
                                 tlora.LoRAConfig(**kw)))
    assert got.keys() == want.keys()
    for path in got:
        # relative to the leaf's largest element: where w + delta cancels,
        # one ulp of the delta is a large share of the sum
        np.testing.assert_allclose(got[path], want[path], rtol=0,
                                   atol=1e-6 * np.abs(want[path]).max(), err_msg=path)
    zero = jax.tree.map(np.zeros_like, adapters)
    same = tlora.merge_lora(tbase, params_from_jax(zero, device="cpu"), tlora.LoRAConfig(**kw))
    for (path, a), (_, b) in zip(tree_paths(same), tree_paths(tbase)):
        assert torch.equal(a, b) and a.dtype == b.dtype, path


@pytest.mark.parametrize("path,axis,rank", [
    ("layers/attn/wq", "model", 1), ("layers/attn/wo", "model", 1),
    ("layers/mlp/wi", "model", 0), ("layers/mlp/wo", "model", 1),
    ("lm_head/w", "model", 1), ("layers/mlp/wi", "expert", 1)])
def test_a_blocks_merge_is_the_whole_merges_slice(path, axis, rank):
    """What a model (or expert) rank merges into its block equals the
    block of the whole merge: the slices of a's fan-in or b's fan-out."""
    from polyaxon_tpu_torch.models import transformer
    from polyaxon_tpu_torch.parallel.mesh import ShardingRules, sharded_dim

    model = "llama-moe-tiny" if axis == "expert" else "llama-tiny"
    cfg = REGISTRY[model][1]
    base = transformer.init(cfg, seed=0, device="cpu")
    lcfg = tlora.LoRAConfig(rank=4, alpha=8.0, target=path.split("/", 1)[-1] + "$")
    adapters = tlora.init_lora(base, lcfg, seed=1)
    for _, t in tree_paths(adapters):
        t.normal_(generator=torch.Generator().manual_seed(2))
    specs = transformer.param_specs(cfg, ShardingRules())
    whole = dict(tree_paths(tlora.merge_lora(base, adapters, lcfg)))[path]
    w = dict(tree_paths(base))[path]
    d = sharded_dim(dict(tree_paths(specs, is_leaf=lambda x: isinstance(x, tuple)))[path],
                    axis)
    n = w.shape[d] // 2
    block = w.narrow(d, rank * n, n)
    coords = {a: 0 for a in ("data", "fsdp", "stage", "expert", "context", "model")}
    coords[axis] = rank
    merge = tlora.adapter_tree(adapters, base, specs, lcfg, coords)
    node = merge
    for part in path.split("/"):
        node = node[part]
    want = whole.narrow(d, rank * n, n)
    tol = dict(rtol=0, atol=1e-6 * want.abs().max().item())
    torch.testing.assert_close(node.apply(block), want, **tol)
    # per layer, as the trunk reads a stacked leaf
    if path.startswith("layers/"):
        for i, layer in enumerate(node.unstack(w.shape[0])):
            torch.testing.assert_close(layer.apply(block[i]), want[i], **tol)


# -- training against the JAX Trainer ----------------------------------------------------


@pytest.mark.parametrize("model,opt", RUNS)
def test_lora_training_matches_the_jax_trainer(inits, jax_runs, model, opt):
    jlogged, jparams = jax_runs[(model, opt)]
    logged, params = _port_run(model, opt, inits[model])
    np.testing.assert_allclose(logged[:, 0], jlogged[:, 0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(logged[:, 1], jlogged[:, 1], rtol=NORM_RTOL)
    start = _flat(inits[model])
    moved = 0.0
    for path, value in params.items():
        if path.startswith("base/"):
            assert np.array_equal(value, start[path]), f"port base leaf {path} moved"
            assert np.array_equal(jparams[path], start[path]), f"JAX base leaf {path} moved"
        else:
            np.testing.assert_allclose(value, jparams[path], atol=ADAPTER_ATOL, err_msg=path)
            moved = max(moved, np.abs(value - start[path]).max())
    assert moved > 10 * ADAPTER_ATOL, "the adapters hardly moved: the check cannot see them"


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_lora_planted_fault_fails_the_jax_comparison(inits, jax_runs, fault,
                                                          monkeypatch):
    norms = Trainer._norms

    def planted(self, grads, cuts, trained, whole):
        norm, clip = norms(self, grads, cuts, trained, whole)
        return (norm, norm) if fault == "clip_by_whole_tree_norm" else (clip, clip)

    monkeypatch.setattr(Trainer, "_norms", planted)
    run = FAULTS[fault]
    worst = _misses(*_port_run(*run, inits[run[0]]), *jax_runs[run])
    assert worst > 1, f"{fault} went unseen: within {worst:.3g} of the tolerances"


def test_lora_under_stage_raises_the_jax_packages_error():
    family, jcfg = JAX_REGISTRY["llama-tiny"]
    with pytest.raises(NotImplementedError) as want:
        JaxTrainer(JaxTrainerConfig(model=jcfg, batch_size=8, seq_len=16),
                   mesh=jax_build_mesh({"stage": 2}, devices=jax.devices()[:2]),
                   task=jlora.LoRATask(jtask_for(family, jcfg), jlora.LoRAConfig(**LORA)))
    cfg = REGISTRY["llama-tiny"][1]
    mesh = Mesh(sizes={"data": 1, "fsdp": 1, "stage": 2, "expert": 1, "context": 1,
                       "model": 1}, distributed=True)
    with pytest.raises(NotImplementedError) as got:
        Trainer(TrainerConfig(model=cfg, batch_size=8, seq_len=16), device="cpu", mesh=mesh,
                task=tlora.LoRATask(task_for("lm", cfg), tlora.LoRAConfig(**LORA)))
    assert str(got.value) == str(want.value)


# -- the builtin runtime -----------------------------------------------------------------


def _logged_run(spec: dict) -> tuple:
    logged = []
    summary = run_builtin(spec, track=lambda i, m: logged.append(m["loss"]))
    return logged, summary


def test_a_lora_checkpoint_saves_restores_and_resumes(tmp_path, monkeypatch):
    """Four steps save {base, lora} params and the adapters' moments at
    steps 2 and 4; restoring step 2 and training on reaches step 4's
    state bit for bit, and the base never moved."""
    monkeypatch.setenv("PLX_ARTIFACTS_PATH", str(tmp_path))
    spec = dict(BUILTIN, steps=4, checkpoint={"save_interval_steps": 2, "async_save": False})
    _logged_run(dict(spec))
    ckdir = tmp_path / "outputs" / "checkpoints"
    saved = read_step(ckdir / "4")
    assert set(saved["params"]) == {"base", "lora"}
    n_adapters = len(tree_paths(saved["params"]["lora"]))
    assert len(saved["opt_state"]["mu"]) == len(saved["opt_state"]["nu"]) == n_adapters
    first = read_step(ckdir / "2")
    for (path, a), (_, b) in zip(tree_paths(first["params"]["base"]),
                                 tree_paths(saved["params"]["base"])):
        assert torch.equal(a, b), path
    # a rerun resumes at its newest complete step
    assert run_builtin(dict(spec))["resumed_from_step"] == 4
    trainer, batches = build_trainer(dict(spec), artifacts_dir=str(tmp_path))
    state, _ = trainer.restore_or_init()
    state, step = trainer.restore(state, step=2)
    assert step == 2 and state.opt_state.count == 2
    tdata.skip_batches(batches, 2)
    state, _ = trainer.fit(batches, num_steps=4, state=state)
    for (path, a), (_, b) in zip(tree_paths(state.params), tree_paths(saved["params"])):
        assert torch.equal(a, b), path
    for name in ("mu", "nu"):
        for a, b in zip(getattr(state.opt_state, name), saved["opt_state"][name]):
            assert torch.equal(a, b)


def test_import_with_lora_starts_from_the_plain_imports_loss(tmp_path):
    from polyaxon_tpu_torch.models import transformer
    from polyaxon_tpu_torch.partition.convert import save_flat

    cfg = REGISTRY["llama-tiny"][1]
    save_flat(transformer.init(cfg, seed=5, device="cpu"), str(tmp_path / "flat"))
    base = dict(BUILTIN, steps=1, checkpoint=False,
                **{"import": {"path": str(tmp_path / "flat"), "layout": "flat"}})
    plain = {k: v for k, v in base.items() if k != "lora"}
    lora_loss, _ = _logged_run(dict(base, seed=3))
    plain_loss, _ = _logged_run(plain)
    fresh_loss, _ = _logged_run({k: v for k, v in base.items() if k != "import"})
    assert lora_loss == plain_loss  # b = 0: the merged base is the base
    assert lora_loss != fresh_loss  # the imported tree, not a fresh init


def test_partition_rules_and_a_tracked_runs_partition_plan(tmp_path, monkeypatch):
    """A run with a user rule trains; its tracked ``partition_plan``
    output is JAX's ``plan_summary_from_shardings`` of the same task, rule
    and mesh; over a {fsdp: 2, model: 2} mesh the port's summary of its
    trainer's specs is JAX's too."""
    rules = [["embed/tokens$", [None, "fsdp"]], ["attn/w[qkv]$", [None, None, "model", None]]]
    monkeypatch.setenv("PLX_ARTIFACTS_PATH", str(tmp_path))
    losses, _ = _logged_run(dict(BUILTIN, steps=2, checkpoint=False, partition_rules=rules))
    assert len(losses) == 2 and all(np.isfinite(losses))
    plan = json.loads((tmp_path / "outputs.json").read_text())["partition_plan"]

    family, jcfg = JAX_REGISTRY["llama-tiny"]
    cfg = REGISTRY["llama-tiny"][1]
    for para, world in (({"data": 1}, 1), ({"fsdp": 2, "model": 2}, 4)):
        jmesh = jax_build_mesh(para, devices=jax.devices()[:world])
        jtr = JaxTrainer(JaxTrainerConfig(model=jcfg, batch_size=8, seq_len=16), mesh=jmesh,
                         task=jlora.LoRATask(jtask_for(family, jcfg),
                                             jlora.LoRAConfig(**LORA)),
                         partition_rules=rules)
        abstract = jax.eval_shape(lambda k: jtr.task.init(k)[0], jax.random.PRNGKey(0))
        want = jax_plan_summary(abstract, jtr.param_shardings, jmesh)
        tr = Trainer(TrainerConfig(model=cfg, batch_size=8, seq_len=16), device="cpu",
                     mesh=Mesh(sizes=dict(jmesh.shape)),
                     task=tlora.LoRATask(task_for("lm", cfg), tlora.LoRAConfig(**LORA)),
                     partition_rules=rules)
        assert plan_summary_from_shardings(tr.task.abstract_params(), tr.specs,
                                           Mesh(sizes=dict(jmesh.shape))) == want
        if world == 1:
            assert plan == {**want, "num_slices": 1}
    assert want["axes_used"] == ["fsdp", "model"]


# -- C8 ------------------------------------------------------------------------------------


def test_moe_serving_fails_its_first_request_in_both_packages():
    from polyaxon_tpu.serve.engine import SamplingParams as JaxSampling
    from polyaxon_tpu.serve.runtime import build_engine as jax_build_engine
    from polyaxon_tpu_torch.serve.engine import SamplingParams
    from polyaxon_tpu_torch.serve.runtime import build_engine

    spec = {"model": "llama-moe-tiny", "platform": "cpu", "block_size": 8,
            "prefill_chunk": 16, "max_seq_len": 64}
    for build, sampling, match in (
            (build_engine, SamplingParams, "no mixture-of-experts branch"),
            (jax_build_engine, JaxSampling, None)):
        engine = build(dict(spec))  # the model is accepted
        engine.submit([1, 2, 3, 4, 5], sampling(max_new_tokens=4))
        with pytest.raises(ValueError, match=match):
            engine.step()


def test_a_lora_config_from_its_spec_forms():
    for spec in (True, {"rank": 16, "alpha": 32, "target": "attn/(wq|wk|wv|wo)$"}, {}):
        ours, theirs = tlora.LoRAConfig.from_spec(spec), jlora.LoRAConfig.from_spec(spec)
        assert (ours.rank, ours.alpha, ours.target, ours.init_scale, ours.scaling) == \
            (theirs.rank, theirs.alpha, theirs.target, theirs.init_scale, theirs.scaling)
    with pytest.raises(tlora.LoRATargetError, match="must be a mapping"):
        tlora.LoRAConfig.from_spec("yes")
    assert replace(tlora.LoRAConfig(), rank=0).scaling == 16.0
