"""Port parity: the model families beyond the causal LM — BERT MLM, ViT and
ResNet — and GPT-2's training, against the JAX package on the CPU, from the
same weights (``convert.params_from_jax``) and the same numpy-made batches
(the port's streams, bit-identical to the JAX package's).

For bert-tiny, gpt2-tiny, vit-tiny and resnet18-cifar (at its bf16 and
in f32): the forward logits (with ResNet's new batch statistics), the
task's loss, accuracy and every grad. Three steps of both trainers at two
microbatches (resnet18-cifar in f32): the losses, each step's metric keys,
ViT's and ResNet's accuracy (the mean over the microbatches) and ResNet's
batch statistics after them. Then the non-causal flash path on both
sides: bert-tiny at seq 128 in 64-row blocks, and vit-tiny on 96-pixel
images (145 tokens: one block of no power of two), JAX's Pallas kernels in
interpret mode against the port's plain versions.

Tolerances. The f32 models sum the same products in other orders, as
``tests/test_torch_train_model.py`` holds llama-tiny: 2e-5 on logits and
loss, grads 1e-5 absolute plus 1e-4 relative, and over three AdamW steps
(whose m/sqrt(v) amplifies last-place differences of near-zero grads)
losses 1e-4 relative and ResNet's batch statistics 2e-3 relative plus 2e-4
absolute. ResNet's grads at batch 4 are batch-norm sums that cancel: in
f32 they are held per leaf by the norm of the difference, 1e-2 (they read
~1e-3). In bf16 (the config's dtype) every convolution and batch norm
rounds its output to bf16, and XLA rounds in other places than torch (it
keeps some elementwise chains in f32): each side's logits lie 0.012-0.019
from the f32 logits (of up to 0.5), so the two are held to 5e-2, the loss
to 1e-2 and the batch statistics to 2^-6; its grads are mostly rounding
(JAX's own bf16 grads lie ~37% from its f32 grads, in norm), so the
port's bf16 grads must lie no farther from JAX's f32 grads than 1.5 times
JAX's bf16 grads do.
"""

from __future__ import annotations

import functools
import importlib
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import REGISTRY as JAX_REGISTRY
from polyaxon_tpu.models import resnet as jresnet
from polyaxon_tpu.models import transformer as jtransformer
from polyaxon_tpu.models import vit as jvit
from polyaxon_tpu.train import data as jdata
from polyaxon_tpu.train import optimizers as jopt
from polyaxon_tpu.train.tasks import task_for as jtask_for
from polyaxon_tpu.train.trainer import Trainer as JaxTrainer
from polyaxon_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from polyaxon_tpu_torch.convert import params_from_jax
from polyaxon_tpu_torch.models import REGISTRY, resnet, transformer, vit
from polyaxon_tpu_torch.models.transformer import flatten
from polyaxon_tpu_torch.train import data as tdata
from polyaxon_tpu_torch.train import optimizers
from polyaxon_tpu_torch.train.data import DataConfig, make_batches
from polyaxon_tpu_torch.train.tasks import task_for
from polyaxon_tpu_torch.train.trainer import Trainer, TrainerConfig

fa = importlib.import_module("polyaxon_tpu_torch.ops.flash_attention")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs six workers on eight cores, and torch's default of one
    thread per core oversubscribes them; two threads keep this file's CPU
    share near one worker's (it also runs faster alone)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# case -> (registry name, dtype override): resnet18-cifar at its bf16, and
# in f32, where only the algorithm (padding, the walk, batch norm) differs
CASES = {"bert-tiny": ("bert-tiny", None), "gpt2-tiny": ("gpt2-tiny", None),
         "vit-tiny": ("vit-tiny", None), "resnet18-cifar": ("resnet18-cifar", None),
         "resnet18-cifar-f32": ("resnet18-cifar", "float32")}
TRAINED = ("bert-tiny", "gpt2-tiny", "vit-tiny", "resnet18-cifar-f32")
SEQ = 32
BATCH = 16        # two microbatches of 8: the JAX step shards a batch over 8 CPU devices
STEPS = 3


def _cfgs(case):
    """(family, JAX config, port config) of a case."""
    name, dtype = CASES[case]
    fam, jcfg = JAX_REGISTRY[name]
    tcfg = REGISTRY[name][1]
    if dtype:
        jcfg = replace(jcfg, dtype=jnp.dtype(dtype))
        tcfg = replace(tcfg, dtype=getattr(torch, dtype))
    return fam, jcfg, tcfg


def _bf16_resnet(case):
    return case == "resnet18-cifar"


def _data_cfg(case, module, batch_size=BATCH, seed=0):
    fam, _, cfg = _cfgs(case)
    kind = task_for(fam, cfg).default_data_kind
    if fam in ("lm", "mlm"):
        return module.DataConfig(kind=kind, batch_size=batch_size, seq_len=SEQ,
                                 vocab_size=cfg.vocab_size, seed=seed)
    return module.DataConfig(kind=kind, batch_size=batch_size, seed=seed,
                             image_size=cfg.image_size if fam == "vit" else 32,
                             num_classes=cfg.num_classes)


def _jbatch(batch):
    return {k: jnp.asarray(v.numpy().astype(np.int32) if v.dtype == torch.int64
                           else v.numpy()) for k, v in batch.items()}


def _init(case, seed=0):
    """The JAX init of a case as numpy: (params, extra). A dtype override
    changes no initial value (params and statistics are f32), so the cases
    of one model share its init."""
    return _model_init(CASES[case][0], seed)


@functools.cache
def _model_init(name, seed):
    fam, jcfg = JAX_REGISTRY[name]
    params, extra = jax.jit(jtask_for(fam, jcfg).init)(jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, (params, extra))


@pytest.fixture(scope="module", params=sorted(CASES))
def family(request):
    """(case, JAX weights and extra as numpy, one batch of 4)."""
    case = request.param
    return case, _init(case), next(make_batches(_data_cfg(case, tdata, 4, seed=1)))


def _forward(case, weights, batch):
    """(JAX logits, port logits, JAX new stats, port new stats)."""
    fam, jcfg, tcfg = _cfgs(case)
    jp = jax.tree.map(jnp.asarray, weights[0])
    tp = params_from_jax(weights[0], device="cpu")
    jb = _jbatch(batch)
    if fam in ("lm", "mlm"):
        return (jax.jit(lambda p, t: jtransformer.apply(p, t, jcfg, interpret=True))(
                    jp, jb["inputs"]),
                transformer.apply(tp, batch["inputs"], tcfg), None, None)
    if fam == "vit":
        return (jax.jit(lambda p, x: jvit.apply(p, x, jcfg, interpret=True))(jp, jb["images"]),
                vit.apply(tp, batch["images"], tcfg), None, None)
    jlogits, jstats = jax.jit(lambda p, s, x: jresnet.apply(p, s, x, jcfg, train=True))(
        jp, jax.tree.map(jnp.asarray, weights[1]), jb["images"])
    logits, stats = resnet.apply(tp, params_from_jax(weights[1], device="cpu"),
                                 batch["images"], tcfg, train=True)
    return jlogits, logits, jstats, stats


def test_logits_match_jax(family):
    case, weights, batch = family
    jlogits, logits, jstats, stats = _forward(case, weights, batch)
    assert logits.dtype == torch.float32 and tuple(logits.shape) == jlogits.shape
    tol = 5e-2 if _bf16_resnet(case) else 2e-5
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=tol,
                               rtol=tol)
    if stats is not None:
        _assert_stats_close(stats, jstats, bf16=_bf16_resnet(case))


def _assert_stats_close(stats, jstats, bf16):
    jflat = dict(flatten(jax.tree.map(np.asarray, jstats)))
    flat = dict(flatten(stats))
    assert set(flat) == set(jflat)
    tol = 2.0 ** -6 if bf16 else 1e-5
    for path, t in flat.items():
        np.testing.assert_allclose(t.numpy(), jflat[path], rtol=tol, atol=tol,
                                   err_msg="/".join(path))


def _port_loss_and_grads(task, params, extra, batch):
    for _, leaf in flatten(params):
        leaf.requires_grad_()
    loss, metrics, _ = task.loss(params, extra, batch)
    loss.backward()
    return loss.item(), metrics, {path: leaf.grad for path, leaf in flatten(params)}


def _jax_loss_and_grads(task, params, extra, batch):
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: task.loss(p, extra, batch, interpret=True)[:2], has_aux=True))(params)
    return float(loss), metrics, dict(flatten(jax.tree.map(np.asarray, grads)))


def _norm_rel(grads: dict, ref: dict) -> float:
    """|grads - ref| / |ref| over every leaf together."""
    diff = sum(float(np.sum((np.asarray(grads[k], np.float64) - ref[k]) ** 2)) for k in ref)
    return (diff / sum(float(np.sum(np.asarray(ref[k], np.float64) ** 2)) for k in ref)) ** 0.5


def test_loss_and_every_grad_match_jax(family):
    case, weights, batch = family
    fam, jcfg, tcfg = _cfgs(case)
    jtask, task = jtask_for(fam, jcfg), task_for(fam, tcfg)
    jextra = None if weights[1] is None else jax.tree.map(jnp.asarray, weights[1])
    jparams = jax.tree.map(jnp.asarray, weights[0])
    jloss, jmetrics, jgrads = _jax_loss_and_grads(jtask, jparams, jextra, _jbatch(batch))
    extra = None if weights[1] is None else params_from_jax(weights[1], device="cpu")
    loss, metrics, grads = _port_loss_and_grads(
        task, params_from_jax(weights[0], device="cpu"), extra, batch)
    grads = {k: g.numpy() for k, g in grads.items()}
    assert set(metrics) == set(jmetrics) and set(grads) == set(jgrads)
    if "accuracy" in metrics:
        assert float(metrics["accuracy"]) == float(jmetrics["accuracy"])
    if _bf16_resnet(case):
        assert loss == pytest.approx(jloss, abs=1e-2)
        # in bf16 these grads are mostly rounding: JAX's own lie ~37% (in
        # norm) from its f32 grads; the port's must lie no farther than 1.5x
        _, f32cfg, _ = _cfgs("resnet18-cifar-f32")
        _, _, jgrads32 = _jax_loss_and_grads(jtask_for(fam, f32cfg), jparams, jextra,
                                             _jbatch(batch))
        assert _norm_rel(grads, jgrads32) <= 1.5 * _norm_rel(jgrads, jgrads32)
        return
    assert loss == pytest.approx(jloss, abs=2e-5)
    if fam == "resnet":
        # batch norm at batch 4 makes its grads sums that cancel: held per
        # leaf in norm, 1e-2, where the f32 readings are ~1e-3
        for path in grads:
            assert _norm_rel({0: grads[path]}, {0: jgrads[path]}) <= 1e-2, "/".join(path)
        return
    for path, g in grads.items():
        np.testing.assert_allclose(g, jgrads[path], atol=1e-5, rtol=1e-4,
                                   err_msg="/".join(path))


# -- three trainer steps ------------------------------------------------------------


@pytest.fixture(scope="module", params=TRAINED)
def fitted(request):
    """Both trainers, three steps from the same weights and batches: (case,
    JAX per-step metrics, port per-step metrics, JAX state, port state)."""
    case = request.param
    fam, jcfg, tcfg = _cfgs(case)
    seq = SEQ if fam in ("lm", "mlm") else 1
    common = dict(batch_size=BATCH, seq_len=seq, microbatches=2, log_interval=1)
    opt = dict(learning_rate=1e-3, warmup_steps=1, total_steps=STEPS)
    jlog, tlog = [], []
    jtrainer = JaxTrainer(JaxTrainerConfig(model=jcfg, parallelism={"data": 1},
                                           optimizer=jopt.OptimizerConfig(**opt), **common),
                          task=jtask_for(fam, jcfg), track=lambda i, m: jlog.append(m))
    trainer = Trainer(TrainerConfig(model=tcfg, accelerator=None,
                                    optimizer=optimizers.OptimizerConfig(**opt), **common),
                      device="cpu", task=task_for(fam, tcfg),
                      track=lambda i, m: tlog.append(m))
    # the trainer's own init_state(seed=0) draws the task's init from key 0
    weights = _init(case)
    jstate = jtrainer.init_state_from(*jax.tree.map(jnp.asarray, weights))
    jstate, _ = jtrainer.fit(jdata.make_batches(_data_cfg(case, jdata)), num_steps=STEPS,
                             state=jstate)
    state = trainer.init_state_from(*params_from_jax(weights, device="cpu"))
    state, _ = trainer.fit(make_batches(_data_cfg(case, tdata)), num_steps=STEPS,
                           state=state)
    return case, jlog, tlog, jstate, state


def test_three_trainer_steps_match_jax(fitted):
    case, jlog, tlog, jstate, state = fitted
    assert len(tlog) == len(jlog) == STEPS
    np.testing.assert_allclose([m["loss"] for m in tlog], [m["loss"] for m in jlog],
                               rtol=1e-4)
    if state.extra is not None:
        # after three AdamW steps the params carry the amplified last-place
        # differences of near-zero grads (up to lr per step on a weight)
        jflat = dict(flatten(jax.tree.map(np.asarray, jstate.extra)))
        for path, t in flatten(state.extra):
            np.testing.assert_allclose(t.numpy(), jflat[path], rtol=2e-3, atol=2e-4,
                                       err_msg="/".join(path))


def test_step_metrics_carry_the_task_metrics(fitted):
    """The port's step returns the task's metrics (each the mean over the
    microbatches) beside loss, grad_norm and the anomaly flags, as the JAX
    step does: vit-tiny's and resnet18-cifar's accuracy, step by step."""
    case, jlog, tlog, _, _ = fitted
    step_keys = {"loss", "accuracy", "grad_norm", "anomaly_loss", "anomaly_grad"}
    for jm, tm in zip(jlog, tlog):
        assert {k for k in jm if k in step_keys} == {k for k in tm if k in step_keys}
        if "accuracy" in jm:
            assert tm["accuracy"] == jm["accuracy"], case
    assert ("accuracy" in tlog[0]) == (_cfgs(case)[0] in ("vit", "resnet"))


# -- the non-causal flash path -----------------------------------------------------

FLASH_CASES = {
    # bert-tiny at seq 128 in 64-row blocks: two q and two kv blocks, no mask
    "bert-tiny-flash": ("bert-tiny", dict(attn_impl="flash", attn_block_q=64,
                                          attn_block_k=64), 128),
    # vit-tiny on 96-pixel images: 144 patches + CLS = 145 tokens in one block
    "vit-tiny-96-flash": ("vit-tiny", dict(attn_impl="flash"), 96),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_noncausal_flash_matches_jax(case, monkeypatch):
    name, over, size = FLASH_CASES[case]
    fam, jcfg = JAX_REGISTRY[name]
    tcfg = REGISTRY[name][1]
    if fam == "vit":
        jcfg = replace(jcfg, image_size=size, encoder=replace(jcfg.encoder, **over))
        tcfg = replace(tcfg, image_size=size, encoder=replace(tcfg.encoder, **over))
        seq = jcfg.num_patches + 1
        data_cfg = DataConfig(kind="synthetic-image", batch_size=2, image_size=size,
                              num_classes=tcfg.num_classes, seed=2)
    else:
        jcfg, tcfg = replace(jcfg, **over), replace(tcfg, **over)
        seq = size
        data_cfg = DataConfig(kind="synthetic-mlm", batch_size=2, seq_len=size,
                              vocab_size=tcfg.vocab_size, seed=2)
    batch = next(make_batches(data_cfg))
    jtask, task = jtask_for(fam, jcfg), task_for(fam, tcfg)
    params, _ = jax.jit(jtask.init)(jax.random.PRNGKey(3))
    weights = jax.tree.map(np.asarray, params)
    jloss, _, jgrads = _jax_loss_and_grads(jtask, jax.tree.map(jnp.asarray, weights), None,
                                           _jbatch(batch))
    calls = []
    plain = fa.flash_fwd_plain

    def counted(q, *args, **kwargs):
        calls.append((q.shape[1], kwargs["causal"]))
        return plain(q, *args, **kwargs)

    monkeypatch.setattr(fa, "flash_fwd_plain", counted)
    loss, _, grads = _port_loss_and_grads(task, params_from_jax(weights, device="cpu"), None,
                                          batch)
    layers = (tcfg.encoder if fam == "vit" else tcfg).num_layers
    assert calls == [(seq, False)] * layers
    assert loss == pytest.approx(jloss, abs=2e-5)
    for path, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[path], atol=1e-5, rtol=1e-4,
                                   err_msg="/".join(path))


def test_patchify_lays_a_patch_out_as_rows_columns_channels():
    images = np.arange(2 * 4 * 4 * 3, dtype=np.float32).reshape(2, 4, 4, 3)
    ours = vit.patchify(torch.tensor(images), 2).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jvit.patchify(jnp.asarray(images), 2)))
    assert ours[0, 1].tolist() == images[0, :2, 2:4].reshape(-1).tolist()


@pytest.mark.parametrize("n,k,stride,pads", [
    (224, 7, 2, (2, 3)), (56, 3, 2, (0, 1)), (32, 3, 2, (0, 1)), (112, 3, 2, (0, 1)),
    (32, 3, 1, (1, 1)), (56, 1, 2, (0, 0)),
])
def test_same_padding_is_xla_s(n, k, stride, pads):
    assert resnet.same_pads(n, k, stride) == pads
    x = np.random.default_rng(0).standard_normal((1, n, n, 1)).astype(np.float32)
    w = np.random.default_rng(1).standard_normal((k, k, 1, 1)).astype(np.float32)
    ref = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (stride, stride),
                                       "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    out = resnet._conv(torch.tensor(x).permute(0, 3, 1, 2), {"w": torch.tensor(w)}, stride)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)


def test_resnet50_stem_and_pool_pad_like_xla():
    """The ImageNet ResNet-50 path (7x7/2 stem, 3x3/2 max-pool, strided
    bottlenecks), one block a stage at width 8, on 36-pixel images (odd
    sizes after the stem), in f32 so that only the padding and the walk can
    differ."""
    jcfg = replace(jresnet.RESNET50, dtype=jnp.float32, stage_sizes=(1, 1, 1, 1), width=8)
    tcfg = replace(resnet.RESNET50, dtype=torch.float32, stage_sizes=(1, 1, 1, 1), width=8)
    params, stats = jax.jit(lambda k: jresnet.init(k, jcfg))(jax.random.PRNGKey(0))
    images = np.random.default_rng(4).standard_normal((2, 36, 36, 3)).astype(np.float32)
    ref, _ = jax.jit(lambda p, s, x: jresnet.apply(p, s, x, jcfg, train=True))(
        params, stats, jnp.asarray(images))
    out, _ = resnet.apply(*params_from_jax(jax.tree.map(np.asarray, (params, stats)),
                                           device="cpu"),
                          torch.tensor(images), tcfg, train=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)
    assert resnet.flops_per_image(tcfg, 224) == jresnet.flops_per_image(jcfg, 224)


def test_configs_and_param_counts_match_jax():
    for name, (fam, cfg) in REGISTRY.items():
        jfam, jcfg = JAX_REGISTRY[name]
        assert fam == jfam, name
        if fam == "vit":
            assert cfg.num_params() == jcfg.num_params(), name
            assert (cfg.image_size, cfg.patch_size, cfg.num_classes, cfg.encoder.eps) == \
                (jcfg.image_size, jcfg.patch_size, jcfg.num_classes, jcfg.encoder.eps)
        elif fam == "resnet":
            assert (cfg.stage_sizes, cfg.num_classes, cfg.width, cfg.small_inputs) == \
                (jcfg.stage_sizes, jcfg.num_classes, jcfg.width, jcfg.small_inputs)
            assert resnet.flops_per_image(cfg, 32) == jresnet.flops_per_image(jcfg, 32)
        else:
            assert cfg.num_params() == jcfg.num_params(), name
    assert set(REGISTRY) == set(JAX_REGISTRY)
