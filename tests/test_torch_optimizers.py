"""Port parity: the port's sgd, lion and adafactor (``polyaxon_tpu_torch.train.
optimizers``) against the JAX package's ``make_optimizer`` (optax) on a
llama tree, five steps from the same params and numpy-made grads, and each
state through the port's checkpointer; then three llama-tiny steps of each
through both trainers.

Tolerances. f32 throughout: the same formulas in the same order, so the
updates agree to 1e-6 relative. Lion's update is a sign, so it agrees
exactly but for the weight decay's last place. XLA may contract ``g +
decay * t`` into one fused multiply-add where torch rounds the product
first, so a sum that cancels to near zero (sgd's trace, the params after
five added updates) differs by a last place of its terms, which are at
most ~0.02 after the clip: 1e-8 absolute. With ``mu_dtype: bfloat16``
XLA computes ``b2 * mu`` in f32 where torch rounds it to bf16 first, so
the stored momentum may round the other way: one bf16 place, at most 2^-7
relative, and where the sum cancels to near zero, one bf16 place of the
leaf's largest term (2^-8 times its largest momentum) absolute. Adafactor's second moments are means over a leaf's rows or
columns, summed in another order by XLA and by torch: 1e-6 relative, as
the updates.
"""

from __future__ import annotations

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from polyaxon_tpu.models import llama as jllama
from polyaxon_tpu.models import transformer as jtransformer
from polyaxon_tpu.train import optimizers as jopt
from polyaxon_tpu_torch.models.transformer import flatten
from polyaxon_tpu_torch.train import optimizers
from polyaxon_tpu_torch.train.checkpoint import CheckpointConfig, Checkpointer

STEPS = 5


# llama-tiny's tree factors no leaf (no second-largest dim reaches 128): the
# wider variant factors the embedding, wi/wg (a tie of 128 and 128) and wo
TREES = {"llama-tiny": jllama.LLAMA_TINY,
         "llama-tiny-h128": replace(jllama.LLAMA_TINY, hidden=128, mlp_dim=128)}


@functools.cache
def _params(name):
    tree = jtransformer.init(jax.random.PRNGKey(0), TREES[name])
    return jax.tree.map(np.asarray, tree)


def _grads(params, step):
    rng = np.random.default_rng(100 + step)
    # steps 0 and 3 have a global norm above the clip
    scale = 3.0 if step in (0, 3) else 0.02
    return jax.tree.map(lambda p: (rng.standard_normal(p.shape) * scale).astype(np.float32),
                        params)


def _leaves(tree):
    return [np.asarray(leaf, np.float32) for _, leaf in flatten(tree)]


CASES = {
    "sgd": dict(name="sgd"),
    "lion": dict(name="lion"),
    "lion-bf16": dict(name="lion", mu_dtype="bfloat16"),
    "adafactor": dict(name="adafactor"),
}


def _run(case, tree_name):
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=8, grad_clip=1.0,
              **CASES[case])
    tx = jopt.make_optimizer(jopt.OptimizerConfig(**kw))
    ours = optimizers.make_optimizer(optimizers.OptimizerConfig(**kw))
    params = _params(tree_name)
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = [torch.tensor(x) for x in _leaves(params)]
    jstate, tstate = tx.init(jparams), ours.init(tparams)
    updates = []
    for step in range(STEPS):
        grads = _grads(params, step)
        jupd, jstate = tx.update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        tupd, tstate = ours.update([torch.tensor(g) for g in _leaves(grads)], tstate,
                                   tparams)
        updates.append((_leaves(jupd), [u.float().numpy() for u in tupd]))
        jparams = jax.tree.map(lambda p, u: p + u, jparams, jupd)
        tparams = [p + u for p, u in zip(tparams, tupd)]
    return jstate, tstate, updates, (_leaves(jparams), tparams)


@pytest.mark.parametrize("case,tree_name", [
    ("sgd", "llama-tiny"), ("lion", "llama-tiny"), ("lion-bf16", "llama-tiny"),
    ("adafactor", "llama-tiny"), ("adafactor", "llama-tiny-h128"),
])
def test_five_steps_match_optax(case, tree_name):
    jstate, tstate, updates, (jparams, tparams) = _run(case, tree_name)
    for step, (ref, got) in enumerate(updates):
        for i, (a, b) in enumerate(zip(got, ref)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9,
                                       err_msg=f"{case} step {step} leaf {i}")
    for a, b in zip(tparams, jparams):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-8)
    assert tstate.count == STEPS
    inner = jstate[1]  # chain(clip, optimizer)
    if case == "sgd":
        for a, b in zip(tstate.trace, _leaves(inner[0].trace)):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-8)
        assert int(inner[1].count) == STEPS
    elif case.startswith("lion"):
        bf16 = case == "lion-bf16"
        for a, b in zip(tstate.mu, _leaves(inner[0].mu)):
            assert a.dtype == (torch.bfloat16 if bf16 else torch.float32)
            if bf16:
                np.testing.assert_allclose(a.float().numpy(), b, rtol=2.0 ** -7,
                                           atol=2.0 ** -8 * np.abs(b).max())
            else:
                np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-9)
        assert int(inner[0].count) == STEPS
    else:
        factored = inner[0]
        for field in ("v_row", "v_col", "v"):
            for a, b in zip(getattr(tstate, field), _leaves(getattr(factored, field))):
                assert a.shape == b.shape, field
                np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-30)
        assert int(factored.count) == STEPS


def test_adafactor_factors_the_two_largest_dims_as_optax():
    from optax._src.factorized import _factored_dims

    shapes = [tuple(leaf.shape) for _, leaf in flatten(_params("llama-tiny-h128"))]
    shapes += [(2, 128, 128), (4, 256, 128, 8), (130, 130), (3, 127, 500), (200,)]
    picked = {s: optimizers.factored_dims(s) for s in shapes}
    for shape, dims in picked.items():
        assert dims == _factored_dims(shape, True, 128), shape
    assert sum(d is not None for d in picked.values()) >= 5


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="Unknown optimizer 'adam8bit'"):
        optimizers.make_optimizer(optimizers.OptimizerConfig(name="adam8bit"))


@pytest.mark.parametrize("case", sorted(CASES) + ["adamw"])
def test_state_round_trips_through_the_checkpointer(case, tmp_path):
    kw = CASES.get(case, dict(name="adamw", mu_dtype="bfloat16"))
    ours = optimizers.make_optimizer(optimizers.OptimizerConfig(
        learning_rate=1e-2, warmup_steps=0, total_steps=8, **kw))
    params = [torch.tensor(x) for x in _leaves(_params("llama-tiny-h128"))]
    state = ours.init(params)
    grads = [torch.tensor(g) for g in _leaves(_grads(_params("llama-tiny-h128"), 0))]
    _, state = ours.update(grads, state, params)
    ck = Checkpointer(CheckpointConfig(directory=str(tmp_path), async_save=False))
    ck.maybe_save(1, {"opt_state": optimizers.opt_state_tree(state)}, force=True)
    fresh = ours.init(params)
    tree, _ = ck.restore({"opt_state": optimizers.opt_state_tree(fresh)})
    restored = optimizers.opt_state_from_tree(tree["opt_state"])
    assert type(restored) is type(state) and restored.count == state.count == 1
    for a, b in zip(optimizers.opt_state_tree(restored).items(),
                    optimizers.opt_state_tree(state).items()):
        if a[0] != "count":
            assert all(torch.equal(x, y) and x.dtype == y.dtype for x, y in zip(a[1], b[1]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_trainer_loss_curve_matches_jax(case):
    """Three llama-tiny steps through both trainers (two microbatches) with
    the optimizer: the losses agree to 1e-4 relative, as AdamW's curve does
    (tests/test_torch_train_step.py)."""
    from polyaxon_tpu.train import data as jdata
    from polyaxon_tpu.train.trainer import Trainer as JaxTrainer
    from polyaxon_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
    from polyaxon_tpu_torch.convert import params_from_jax
    from polyaxon_tpu_torch.models import llama
    from polyaxon_tpu_torch.train import data
    from polyaxon_tpu_torch.train.trainer import Trainer, TrainerConfig

    steps = 3
    opt = dict(learning_rate=1e-3, warmup_steps=1, total_steps=steps, **CASES[case])
    common = dict(batch_size=16, seq_len=32, microbatches=2, log_interval=1)
    data_kw = dict(kind="synthetic-lm", batch_size=16, seq_len=32, vocab_size=256, seed=7)
    jlosses, losses = [], []
    jtrainer = JaxTrainer(JaxTrainerConfig(model=jllama.LLAMA_TINY, parallelism={"data": 1},
                                           optimizer=jopt.OptimizerConfig(**opt), **common),
                          track=lambda i, m: jlosses.append(m["loss"]))
    jstate = jtrainer.init_state(seed=0)
    weights = jax.tree.map(np.asarray, jstate.params)
    jtrainer.fit(jdata.make_batches(jdata.DataConfig(**data_kw)), num_steps=steps,
                 state=jstate)
    trainer = Trainer(TrainerConfig(model=llama.LLAMA_TINY, accelerator=None,
                                    optimizer=optimizers.OptimizerConfig(**opt), **common),
                      device="cpu", track=lambda i, m: losses.append(m["loss"]))
    state = trainer.init_state_from(params_from_jax(weights, device="cpu"))
    trainer.fit(data.make_batches(data.DataConfig(**data_kw)), num_steps=steps, state=state)
    assert len(losses) == steps
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
