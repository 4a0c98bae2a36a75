"""The port's tensor and context parallelism on gloo groups, against the
JAX package's SPMD trainer on CPU meshes of the same shape.

One group of two worker processes (``tests/fixtures/torch_dist_worker.py``,
one thread each) and one of four run every case through
``run_builtin`` with ``PLX_*`` env and ``platform: cpu``, three steps each,
from the JAX init (``fork_from`` a port checkpoint of it), while this
process runs the JAX ``Trainer`` on ``build_mesh(same,
devices=jax.devices()[:world])`` and the port's one process:

- two ranks: llama-tiny ``{model: 2}``, ``{context: 2}`` with ring and with
  Ulysses attention (the config's ``seq_parallel``), bert-tiny ``{model:
  2}`` (the biases added after the sum) and ``{context: 2}`` (the
  non-causal ring, MLM counts over batch x context), gpt2-tiny ``{model:
  2}`` (the tied vocab-parallel head), and llama-tiny under the llama
  recipes' remat policies (``{context: 2}`` with ``attn_qkv`` at two
  microbatches, ``{model: 2}`` with ``dots``), vit-tiny ``{model: 2}``
  (the encoder split, the rest replicated);
- four ranks: llama-tiny ``{fsdp: 2, model: 2}`` (leaves sharded on two
  dims; its checkpoint restores at world 1 bit-equal and into each rank's
  block), ``{model: 2, context: 2}``, ``{fsdp: 2, context: 2}`` (fsdp
  shards' grads summed over context), and one forward at ``{context: 4}``
  with Ulysses, four context ranks over llama-tiny's two kv heads
  (``tests/test_models.py``'s pre-expansion case), against JAX's unsharded
  ``transformer.apply``;
- three planted faults (a bias added before the model sum, each context
  rank's positions starting at 0, replicated leaves counted once per
  model rank in the global norm) must each fail the JAX comparison;
- LoRA (``lora:``, the JAX ``LoRATask`` with ``frozen_base_optimizer``):
  two ranks of llama-tiny under ``{data: 2}``, ``{fsdp: 2}`` (each layer's
  delta added after its gather), ``{model: 2}`` and ``{context: 2}``, and
  bert-tiny under ``{model: 2}`` (each model rank merging its block's
  delta, the adapters' grads summed over model); a planted fault leaving
  those grads unsummed must fail;
- four ranks: the JAX package's overlay case (``{fsdp: 2, model: 2}`` with
  ``attn/w[qkv]$ -> [null, null, model, null]``: wq/wk/wv not fsdp-cut)
  against JAX like the runs above; and ``{data: 2, fsdp: 2}`` at
  ``num_slices: 2`` bit-equal to ``num_slices: 1``
  (``tests/test_multislice.py``'s parity);
- adafactor over cut leaves, on a hidden-128 llama (llama-tiny's tree
  factors nothing): ``{fsdp: 2}``, ``{model: 2}``, llama-moe ``{expert:
  2}`` and ``{fsdp: 2, model: 2}``, its final factors and moments against
  JAX's too; three planted faults (factored by the block's shape, factor
  means over the block alone, the RMS of the block) must each fail;
- user rules on the model axis, stored as the rule says and resharded
  where the layer bodies read them: the example's ``embed/tokens$ ->
  [null, fsdp]``, ``wq`` cut on its head dim (also at ``{fsdp: 2, model:
  2}`` and with LoRA), a norm scale cut over model; each rank's first-step
  grads of every leaf held against JAX's; a reshard whose backward is the
  plain adjoint must fail;
- ResNet (f32, batch 4) under ``{model: 2}`` and ``{data: 2, context: 2}``
  (the compute replicated) and ViT on 24-pixel images (nine patches and
  the CLS) under ``{context: 2}``, with first-step grads; ResNet grads
  summed over model must fail;
- an adafactor run saved at ``{fsdp: 2}`` and a rule's run saved at
  ``{model: 2}`` each resume at one rank (the latter without the rule) to
  the unbroken run's losses.

Tolerances, those of ``tests/test_torch_distributed.py``: f32 sums in other
orders, losses and grad norms at 1e-4 relative against JAX over three
AdamW steps, final params at 3e-4 absolute (lr 1e-3 a step where a grad
near zero has a rounding sign); against the port's one process 2e-6
relative and 1e-5 absolute. The model axis adds partial products summed
over ranks and the context axis attention merged over chunks: reorderings
of the same size. The forward is held at ``tests/test_models.py``'s 3e-5
absolute and 1e-4 relative; first-step grads at
``tests/test_torch_pipeline.py``'s GRAD_TOL, adafactor's moments at
FACTOR_TOL, ResNet's three steps at RESNET_JAX_TOL (see there). A fault fails when its loss, grad norm or
param reading misses JAX's by more than these limits. LoRA runs are held
to ``tests/test_torch_lora.py``'s limits (1e-6 relative on losses and
grad norms, 1e-5 absolute on the final adapters; the base bit-equal to its
start): only the adapters train, from b = 0.
"""

from __future__ import annotations

import functools
import json
import math
import os
import shutil
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
from polyaxon_tpu.models import transformer as jtransformer
from polyaxon_tpu.parallel import build_mesh as jax_build_mesh
from polyaxon_tpu.train import data as jdata
from polyaxon_tpu.train import optimizers as jopt
from polyaxon_tpu.train.tasks import task_for as jtask_for
from polyaxon_tpu.train.trainer import Trainer as JaxTrainer
from polyaxon_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from polyaxon_tpu_torch.convert import params_from_jax
from polyaxon_tpu_torch.models import REGISTRY, resnet
from polyaxon_tpu_torch.models.transformer import flatten
from polyaxon_tpu_torch.parallel.mesh import normalize_axis_sizes
from polyaxon_tpu_torch.runtime.builtin import build_trainer, run_builtin
from polyaxon_tpu_torch.train.checkpoint import CheckpointConfig, Checkpointer, read_step
from polyaxon_tpu_torch.train.tasks import LMTask

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "fixtures" / "torch_dist_worker.py"
STEPS = 3
LR = 1e-3
JAX_TOL = (1e-4, 1e-4, 3e-4)     # loss rtol, grad-norm rtol, final-param atol
SELF_TOL = (2e-6, 2e-6, 1e-5)
FACTOR_TOL = 1e-4                # adafactor's moments, relative (f32 means)
# a key bias's exact grad is zero (softmax is shift-invariant per row):
# its relative error is noise
ZERO_GRAD_LEAVES = ("attn/bk",)
FORWARD_TOL = (3e-5, 1e-4)       # atol, rtol
GRAD_TOL = (1e-4, 2e-5)          # rtol, atol as a share of the leaf's largest |grad|
BASE = {"steps": STEPS, "batch_size": 8, "seq_len": 32, "learning_rate": LR,
        "warmup_steps": 1, "log_interval": 1, "platform": "cpu", "watchdog": False,
        "checkpoint": {"save_interval_steps": STEPS, "async_save": False}}
# moves wq's model cut from the heads to the head dim
A16_RULES = [["attn/wq$", [None, "fsdp", None, "model"]]]
# examples/llama7b_import_lora.yaml's: the token table loses its model cut
EMBED_RULES = [["embed/tokens$", [None, "fsdp"]]]
# a norm scale the built-in rules replicate, cut over model
NORM_RULES = [["attn_norm/scale$", [None, "model"]]]
# adafactor scales its step by the param's RMS (~0.02 here): at 50x AdamW's
# learning rate it moves the params as far as AdamW's 1e-3 does
ADAFACTOR_KEYS = {"optimizer": "adafactor", "learning_rate": 50 * LR}
# ResNet at batch 4, as tests/test_torch_families.py trains it: its f32
# grads there hold GRAD_TOL against JAX's; at batch 8 its batch-norm
# backward at init is ill-conditioned in f32, in either package, and the
# two packages' f32 grads part by ~1e-2 of a leaf's norm
RESNET_KEYS = {"batch_size": 4}
# over three AdamW steps its batch-norm grads' last places move the grad
# norm by 1.0e-4 of step 3's and a parameter whose grad is near zero by up
# to a step (lr 1e-3; one reads 4.5e-4): tests/test_torch_families.py holds
# its three-step losses alone, at 1e-4
RESNET_JAX_TOL = (1e-4, 2e-4, 1e-3)
# test-local variants of the zoo's configs: name -> (registry model, config
# changes, f32)
VARIANTS = {"llama-tiny-h128": ("llama-tiny", {"hidden": 128, "mlp_dim": 128}, False),
            "llama-moe-tiny-h128": ("llama-moe-tiny", {"hidden": 128, "mlp_dim": 128}, False),
            # a batch-norm net's small-batch grads in bf16 are mostly rounding
            "resnet18-cifar-f32": ("resnet18-cifar", {}, True),
            "vit-tiny-24": ("vit-tiny", {"image_size": 24}, False)}
# name -> (model, parallelism, seq_parallel, runtime keys)
RUNS = {
    "llama_model": ("llama-tiny", {"model": 2}, "ring", {}),
    "llama_ring": ("llama-tiny", {"context": 2}, "ring", {}),
    "llama_ulysses": ("llama-tiny", {"context": 2}, "ulysses", {}),
    "bert_model": ("bert-tiny", {"model": 2}, "ring", {}),
    "bert_ring": ("bert-tiny", {"context": 2}, "ring", {}),
    "gpt2_model": ("gpt2-tiny", {"model": 2}, "ring", {}),
    # the llama recipes' remat policies: the ring and the model sums rerun
    # in the backward's recompute, under two microbatches
    "llama_ring_remat": ("llama-tiny", {"context": 2}, "ring",
                         {"remat": "attn_qkv", "microbatches": 2}),
    "llama_model_dots": ("llama-tiny", {"model": 2}, "ring", {"remat": "dots"}),
    # ViT's encoder over model (its patch embedding, CLS and head replicated)
    "vit_model": ("vit-tiny", {"model": 2}, None, {}),
    "llama_fsdp_model": ("llama-tiny", {"fsdp": 2, "model": 2}, "ring", {}),
    "llama_model_ring": ("llama-tiny", {"model": 2, "context": 2}, "ring", {}),
    # fsdp shards whose reduce-scattered grads are then summed over context
    "llama_fsdp_ring": ("llama-tiny", {"fsdp": 2, "context": 2}, "ring", {}),
    # the JAX package's overlay case: wq/wk/wv keep their model cut, lose fsdp's
    "llama_overlay": ("llama-tiny", {"fsdp": 2, "model": 2}, "ring",
                      {"partition_rules": [["attn/w[qkv]$", [None, None, "model", None]]]}),
    # adafactor over cut leaves: factored by the logical shape, the factors
    # whole on every rank (a hidden-128 tree: llama-tiny's factors nothing)
    "af_fsdp": ("llama-tiny-h128", {"fsdp": 2}, "ring", ADAFACTOR_KEYS),
    "af_model": ("llama-tiny-h128", {"model": 2}, "ring", ADAFACTOR_KEYS),
    "af_expert": ("llama-moe-tiny-h128", {"expert": 2}, "ring", ADAFACTOR_KEYS),
    "af_fsdp_model": ("llama-tiny-h128", {"fsdp": 2, "model": 2}, "ring", ADAFACTOR_KEYS),
    # user rules on the model axis, resharded where the leaf is read
    "a16_embed": ("llama-tiny", {"model": 2}, "ring", {"partition_rules": EMBED_RULES}),
    "a16_wq": ("llama-tiny", {"model": 2}, "ring", {"partition_rules": A16_RULES}),
    "a16_norm": ("llama-tiny", {"model": 2}, "ring", {"partition_rules": NORM_RULES}),
    "a16_fsdp_model": ("llama-tiny", {"fsdp": 2, "model": 2}, "ring",
                       {"partition_rules": A16_RULES}),
    # ResNet's compute replicated over model and context; ViT's tokens cut
    # over context (nine patches and the CLS)
    "resnet_model": ("resnet18-cifar-f32", {"model": 2}, None, RESNET_KEYS),
    "resnet_data_context": ("resnet18-cifar-f32", {"data": 2, "context": 2}, None,
                            RESNET_KEYS),
    "vit_ring": ("vit-tiny-24", {"context": 2}, None, {}),
}
# the cases whose first-step grads every rank saves, held leaf by leaf
CAPTURED = ("a16_embed", "a16_wq", "a16_norm", "a16_fsdp_model", "resnet_model",
            "resnet_data_context", "vit_ring")
ADAFACTOR = ("af_fsdp", "af_model", "af_expert", "af_fsdp_model")
LORA = {"rank": 4, "alpha": 8.0}
LORA_TOL = (1e-6, 1e-6, 1e-5)    # loss rtol, grad-norm rtol, final-adapter atol
LORA_RUNS = {
    "lora_a16": ("llama-tiny", {"model": 2}, "ring", {"lora": LORA,
                                                      "partition_rules": A16_RULES}),
    "lora_data": ("llama-tiny", {"data": 2}, "ring", {"lora": LORA}),
    "lora_fsdp": ("llama-tiny", {"fsdp": 2}, "ring", {"lora": LORA}),
    "lora_model": ("llama-tiny", {"model": 2}, "ring", {"lora": LORA}),
    "lora_ring": ("llama-tiny", {"context": 2}, "ring", {"lora": LORA}),
    "lora_bert_model": ("bert-tiny", {"model": 2}, "ring", {"lora": LORA}),
}
ALL_RUNS = {**RUNS, **LORA_RUNS}
LORA_FAULTS = {"lora_unsummed_over_model": "lora_model"}
SLICES = {"data": 2, "fsdp": 2}
# planted fault -> the run it breaks
FAULTS = {"bias_before_sum": "bert_model", "local_positions": "llama_ring",
          "norm_counts_replicated": "gpt2_model", "af_block_shape": "af_fsdp",
          "af_local_means": "af_model", "af_block_rms": "af_fsdp",
          "reshard_adjoint": "a16_embed", "resnet_grads_over_model": "resnet_model"}
FORWARD = {"model": "llama-tiny", "parallelism": {"context": 4}, "seq_parallel": "ulysses",
           "batch": 4, "seq": 64}


def _world(para: dict) -> int:
    return math.prod(para.values())


def _free_ports(n: int) -> list:
    """``n`` distinct free ports (the sockets stay bound until all are
    picked, so the two groups never draw the same one)."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _variant(model: str) -> tuple:
    """(registry model, config changes, f32) of a case's model."""
    return VARIANTS.get(model, (model, {}, False))


def _jax_config(model: str) -> tuple:
    base, changes, f32 = _variant(model)
    family, cfg = JAX_REGISTRY[base]
    if f32:
        changes = {**changes, "dtype": jnp.float32}
    return family, replace(cfg, **changes)


def _jax_init(model: str):
    family, cfg = _jax_config(model)
    trainer = JaxTrainer(JaxTrainerConfig(model=cfg, batch_size=8, seq_len=32),
                         mesh=jax_build_mesh({"data": 1}, devices=jax.devices()[:1]),
                         task=jtask_for(family, cfg))
    return jax.tree.map(np.asarray, trainer.init_state(seed=0).params)


def _lora_init(init) -> dict:
    """{base: init, lora: JAX init_lora's adapters}, as numpy."""
    from polyaxon_tpu.partition.lora import LoRAConfig, init_lora

    lora = init_lora(jax.random.PRNGKey(1), jax.tree.map(jnp.asarray, init), LoRAConfig(**LORA))
    return {"base": init, "lora": jax.tree.map(np.asarray, lora)}


def _jax_run(name: str, init) -> tuple:
    """The JAX Trainer on a mesh of the case's shape from ``init``: per-step
    metrics and final params, as numpy."""
    from polyaxon_tpu.partition.lora import LoRAConfig, LoRATask, frozen_base_optimizer

    model, para, seq_parallel, keys = ALL_RUNS[name]
    family, cfg = _jax_config(model)
    if seq_parallel:
        cfg = replace(cfg, seq_parallel=seq_parallel, remat=keys.get("remat", cfg.remat))
    mesh = jax_build_mesh(para, devices=jax.devices()[:_world(para)])
    logged = []
    ocfg = jopt.OptimizerConfig(name=keys.get("optimizer", "adamw"),
                                learning_rate=keys.get("learning_rate", LR), warmup_steps=1,
                                total_steps=STEPS)
    task, tx = jtask_for(family, cfg), None
    if "lora" in keys:
        task = LoRATask(task, LoRAConfig(**keys["lora"]))
        tx = frozen_base_optimizer(jopt.make_optimizer(ocfg))
    batch_size = keys.get("batch_size", BASE["batch_size"])
    trainer = JaxTrainer(
        JaxTrainerConfig(model=cfg, batch_size=batch_size, seq_len=BASE["seq_len"],
                         log_interval=1, parallelism=para,
                         microbatches=keys.get("microbatches", 1), optimizer=ocfg),
        mesh=mesh, task=task, track=lambda i, m: logged.append(m), tx=tx,
        partition_rules=keys.get("partition_rules"))
    # a ResNet's initial batch statistics (mean 0, variance 1)
    stats = task.init(jax.random.PRNGKey(0))[1] if family == "resnet" else None
    state = trainer.init_state_from(jax.tree.map(jnp.asarray, init), stats)
    kind = {"mlm": "synthetic-mlm", "vit": "synthetic-image",
            "resnet": "synthetic-image"}.get(family, "synthetic-lm")
    dcfg = jdata.DataConfig(kind=kind, batch_size=batch_size, seq_len=BASE["seq_len"],
                            vocab_size=getattr(cfg, "vocab_size", 32000),
                            image_size=getattr(cfg, "image_size", 32),
                            num_classes=getattr(cfg, "num_classes", 1000), seed=0)
    extra = {}
    if name in CAPTURED:
        extra["grads"] = _jax_grads(model, batch_size)
    state, _ = trainer.fit(jdata.make_batches(dcfg, mesh), num_steps=STEPS, state=state)
    if name in ADAFACTOR:
        factored = state.opt_state[1][0]  # chain(clip, adafactor)'s first state
        extra.update({f: _flat(getattr(factored, f)) for f in ("v_row", "v_col", "v")})
    return [{"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
            for m in logged], _flat(state.params), extra


@functools.cache
def _jax_grads(model: str, batch_size: int) -> dict:
    """JAX's grads of the task loss on the first batch at the init: the
    first step's grads on any mesh (one device here; GSPMD's are the same
    logical values)."""
    family, cfg = _jax_config(model)
    task = jtask_for(family, cfg)
    # the JAX Trainer's init_state(seed=0): the task's init from key 0
    params, stats = task.init(jax.random.PRNGKey(0))
    kind = {"mlm": "synthetic-mlm", "vit": "synthetic-image",
            "resnet": "synthetic-image"}.get(family, "synthetic-lm")
    dcfg = jdata.DataConfig(kind=kind, batch_size=batch_size, seq_len=BASE["seq_len"],
                            vocab_size=getattr(cfg, "vocab_size", 32000),
                            image_size=getattr(cfg, "image_size", 32),
                            num_classes=getattr(cfg, "num_classes", 1000), seed=0)
    batch = next(iter(jdata.make_batches(dcfg)))
    grads = jax.jit(jax.grad(lambda p: task.loss(p, stats, batch)[0]))(params)
    return _flat(grads)


def _flat(tree) -> dict:
    return {"/".join(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _fork_dir(root: Path, model: str, init) -> str:
    """A port checkpoint of the JAX init, for ``fork_from`` (a ResNet's with
    its initial batch statistics, JAX's law)."""
    path = root / "fork" / model
    family, cfg = REGISTRY.get(_variant(model)[0], (None, None))
    extra = resnet.init(cfg, device="cpu")[1] if family == "resnet" else None
    ckpt = Checkpointer(CheckpointConfig(directory=str(path), async_save=False))
    ckpt.maybe_save(0, {"params": params_from_jax(init, device="cpu"), "opt_state": {},
                        "step": 0, "extra": extra}, force=True)
    ckpt.wait()
    return str(path)


def _spec(name: str, forks: dict) -> dict:
    model, para, seq_parallel, keys = ALL_RUNS[name]
    base = BASE if seq_parallel else {k: v for k, v in BASE.items() if k != "seq_len"}
    return {**base, **keys, "model": _variant(model)[0], "parallelism": para,
            "fork_from": {"path": forks[model, "lora" in keys]}}


def _case(run: str, forks: dict, **more) -> dict:
    """A worker case of run ``run`` (``more``: other keys, a name of its
    own), with its model's variant."""
    _, changes, f32 = _variant(ALL_RUNS[run][0])
    case = {"name": run, "spec": _spec(run, forks), "seq_parallel": ALL_RUNS[run][2],
            "model_cfg": changes, "f32": f32, "capture_grads": run in CAPTURED}
    return {**case, **more}


def _start_group(root: Path, out: Path, world: int, port: int, cases: list) -> tuple:
    """Start one gloo group of ``world`` worker processes on ``cases``."""
    plan = root / f"plan{world}.json"
    plan.write_text(json.dumps({"world": world, "port": port, "out": str(out),
                                "timeout_s": 120, "cases": cases}))
    env = {k: v for k, v in os.environ.items() if not k.startswith("PLX_")}
    # one thread a rank: six ranks run beside this process's JAX trainers
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


def _one_process(art: Path, spec: dict, seq_parallel: str, variant: str) -> list:
    """``run_builtin`` in this process, with ``art`` as its artifacts
    directory; returns the logged loss and grad norm of each step."""
    art.mkdir(parents=True, exist_ok=True)
    model = spec["model"]
    saved = REGISTRY[model]
    _, changes, f32 = _variant(variant)
    changes = {**changes, **({"dtype": torch.float32} if f32 else {}),
               **({"seq_parallel": seq_parallel} if seq_parallel else {})}
    REGISTRY[model] = (saved[0], replace(saved[1], **changes))
    before = os.environ.get("PLX_ARTIFACTS_PATH")
    os.environ["PLX_ARTIFACTS_PATH"] = str(art)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the tiny models gain nothing from more
    logged = []
    try:
        run_builtin(spec, track=lambda i, m: logged.append(
            {"loss": m["loss"], "grad_norm": m["grad_norm"]}))
    finally:
        torch.set_num_threads(threads)
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case: the gloo groups run in the background while this
    process runs the JAX trainers and the port's one process. Returns (JAX
    results, one-process results, case dir root, the forward's inputs)."""
    root = tmp_path_factory.mktemp("tp_cp")
    out = root / "cases"
    inits = {m: _jax_init(m) for m in sorted({r[0] for r in ALL_RUNS.values()})}
    lora_inits = {m: _lora_init(inits[m]) for m in sorted({r[0] for r in LORA_RUNS.values()})}
    forks = {(m, False): _fork_dir(root, m, init) for m, init in inits.items()}
    forks.update({(m, True): _fork_dir(root, f"{m}-lora", init)
                  for m, init in lora_inits.items()})
    cases2, cases4 = [], []
    for name, (model, para, seq_parallel, _) in ALL_RUNS.items():
        (cases2 if _world(para) == 2 else cases4).append(_case(name, forks))
    for fault, run in {**FAULTS, **LORA_FAULTS}.items():
        cases2.append(_case(run, forks, name=f"fault_{fault}", fault=fault,
                            capture_grads=False))
    plain = {k: v for k, v in _spec("llama_overlay", forks).items()
             if k not in ("partition_rules", "checkpoint")}
    # an adafactor run and an A16 rule's, saved at two ranks, restored at one
    for name in ("af_fsdp", "a16_embed"):
        cases2.append(_case(name, forks, name=f"{name}_half",
                            spec={**_spec(name, forks), "steps": 1}))
    for n in (1, 2):
        cases4.append({"name": f"slices{n}", "seq_parallel": "ring",
                       "spec": {**plain, "parallelism": SLICES, "num_slices": n,
                                "checkpoint": False}})
    # the 4-rank run's checkpoint restored into each rank's block
    restore = {k: v for k, v in _spec("llama_fsdp_model", forks).items() if k != "fork_from"}
    cases4.append({"name": "restore_blocks", "restore_shards": True,
                   "artifacts": "llama_fsdp_model", "spec": restore})
    # the Ulysses forward over more context ranks than kv heads
    tokens = np.random.default_rng(1).integers(
        0, 256, (FORWARD["batch"], FORWARD["seq"])).astype(np.int32)
    np.save(root / "tokens.npy", tokens)
    torch.save(params_from_jax(inits[FORWARD["model"]], device="cpu"), root / "params.pt")
    cases4.append({"name": "ulysses_forward", "forward": True,
                   "seq_parallel": FORWARD["seq_parallel"],
                   "params": str(root / "params.pt"), "tokens": str(root / "tokens.npy"),
                   "spec": {"model": FORWARD["model"],
                            "parallelism": FORWARD["parallelism"]}})
    ports = _free_ports(2)
    groups = [_start_group(root, out, 2, ports[0], cases2),
              _start_group(root, out, 4, ports[1], cases4)]
    try:
        jax_results = {name: _jax_run(name, inits[RUNS[name][0]]) for name in RUNS}
        jax_results.update({name: _jax_run(name, lora_inits[LORA_RUNS[name][0]])
                            for name in LORA_RUNS})
        single = {}
        for name, (model, _, seq_parallel, _) in RUNS.items():
            art = root / "single" / name
            spec = {**_spec(name, forks), "parallelism": None}
            single[name] = {"logged": _one_process(art, spec, seq_parallel, model),
                            "params": _final_params(art)}
    finally:
        for procs, logs in groups:
            _join(procs, logs)
    return jax_results, single, out, (tokens, inits[FORWARD["model"]]), lora_inits


def _misses(logged: list, params: dict, jlogged: list, jparams: dict,
            tol: tuple = JAX_TOL) -> float:
    """The worst reading of a run against JAX's, as a multiple of its
    tolerance (> 1: the comparison fails)."""
    loss_tol, norm_tol, param_tol = tol
    worst = max(np.abs(_curve(logged, "loss") / _curve(jlogged, "loss") - 1).max() / loss_tol,
                np.abs(_curve(logged, "grad_norm") / _curve(jlogged, "grad_norm") - 1).max()
                / norm_tol)
    for path, value in params.items():
        worst = max(worst, np.abs(value - jparams[path]).max() / param_tol)
    return float(worst)


def _jax_tol(name: str) -> tuple:
    return RESNET_JAX_TOL if ALL_RUNS[name][3] is RESNET_KEYS else JAX_TOL


@pytest.mark.parametrize("name", sorted(RUNS))
def test_tp_cp_ranks_match_the_jax_mesh(runs, name):
    jax_results, _, out, _, _ = runs
    jlogged, jparams, _ = jax_results[name]
    loss_tol, norm_tol, param_tol = _jax_tol(name)
    for rank in range(_world(RUNS[name][1])):
        logged = _rank(out / name, rank)["logged"]
        np.testing.assert_allclose(_curve(logged, "loss"), _curve(jlogged, "loss"),
                                   rtol=loss_tol)
        np.testing.assert_allclose(_curve(logged, "grad_norm"),
                                   _curve(jlogged, "grad_norm"), rtol=norm_tol)
    for path, value in _final_params(out / name).items():
        np.testing.assert_allclose(value, jparams[path], atol=param_tol, err_msg=path)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_tp_cp_ranks_match_one_process(runs, name):
    _, single, out, _, _ = runs
    loss_tol, norm_tol, param_tol = SELF_TOL
    logged = _rank(out / name, 0)["logged"]
    for key, tol in (("loss", loss_tol), ("grad_norm", norm_tol)):
        np.testing.assert_allclose(_curve(logged, key), _curve(single[name]["logged"], key),
                                   rtol=tol)
    for path, value in _final_params(out / name).items():
        np.testing.assert_allclose(value, single[name]["params"][path], atol=param_tol,
                                   err_msg=path)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_tp_cp_planted_fault_fails_the_jax_comparison(runs, fault):
    jax_results, _, out, _, _ = runs
    run = FAULTS[fault]
    jlogged, jparams, jextra = jax_results[run]
    case = out / f"fault_{fault}"
    worst = _misses(_rank(case, 0)["logged"], _final_params(case), jlogged, jparams,
                    _jax_tol(run))
    if run in ADAFACTOR:
        worst = max(worst, _factor_misses(case, jextra))
    assert worst > 1, f"{fault} went unseen: within {worst:.3g} of the tolerances"


def test_fsdp_model_checkpoint_restores_at_world_one_bit_equal(runs):
    _, _, out, _, _ = runs
    case = out / "llama_fsdp_model"
    saved = read_step(case / "outputs" / "checkpoints" / str(STEPS))
    spec = {**BASE, "model": "llama-tiny"}
    trainer, _ = build_trainer(spec, artifacts_dir=str(case))
    state, step = trainer.restore_or_init()
    assert step == STEPS
    for (path, t), (_, s) in zip(flatten(state.params), flatten(saved["params"])):
        assert torch.equal(t, s), path
    for name in ("mu", "nu"):
        for t, s in zip(getattr(state.opt_state, name), saved["opt_state"][name]):
            assert torch.equal(t, s)


def test_the_checkpoint_restores_into_each_ranks_block(runs):
    """Each of the four ranks holds its model block of every model-sharded
    leaf, cut again by fsdp where the leaf is fsdp-sharded too (``wi``:
    hidden over fsdp, mlp over model), of the params and both moments."""
    _, _, out, _, _ = runs
    full = read_step(out / "llama_fsdp_model" / "outputs" / "checkpoints" / str(STEPS))
    from polyaxon_tpu_torch.parallel import ShardingRules
    from polyaxon_tpu_torch.parallel.mesh import sharded_dim

    specs = [s for _, s in flatten(LMTask(REGISTRY["llama-tiny"][1])
                                   .param_specs(ShardingRules()))]
    leaves = {}
    for i, (path, t) in enumerate(flatten(full["params"])):
        for key, value in (("params/" + "/".join(path), t),
                           (f"mu/{i}", full["opt_state"]["mu"][i]),
                           (f"nu/{i}", full["opt_state"]["nu"][i])):
            leaves[key] = (value, sharded_dim(specs[i]), sharded_dim(specs[i], "model"))
    cut_twice = 0
    for rank in range(4):
        meta = _rank(out / "restore_blocks", rank)
        assert meta["restored_step"] == STEPS
        shards = torch.load(out / "restore_blocks" / f"rank{rank}.pt", weights_only=True)
        assert set(shards) == set(leaves)
        for key, shard in shards.items():
            want, d, md = leaves[key]
            if md is not None:
                n = want.shape[md] // 2
                want = want.narrow(md, meta["model_index"] * n, n)
            if d is not None:
                n = want.shape[d] // 2
                want = want.narrow(d, meta["fsdp_index"] * n, n)
            assert torch.equal(shard, want), key
            cut_twice += d is not None and md is not None
    # wq, wk, wv, wo, wi, wg, mlp wo, the token table and the head
    assert cut_twice == 4 * 3 * 9


def test_ulysses_forward_with_more_context_ranks_than_kv_heads(runs):
    """cp 4 > llama-tiny's 2 kv heads with Ulysses: kv is expanded to the q
    heads before the all-to-all, and the four chunks' logits are JAX's
    unsharded ``apply``."""
    _, _, out, (tokens, init), _ = runs
    cfg = replace(JAX_REGISTRY[FORWARD["model"]][1], seq_parallel="ulysses")
    assert cfg.num_kv_heads < 4 <= cfg.num_heads
    ref = np.asarray(jtransformer.apply(jax.tree.map(jnp.asarray, init),
                                        jnp.asarray(tokens), cfg))
    chunks = [(_rank(out / "ulysses_forward", r)["cols"],
               torch.load(out / "ulysses_forward" / f"rank{r}.pt").numpy()) for r in range(4)]
    assert [c[0] for c in chunks] == [[r * 16, (r + 1) * 16] for r in range(4)]
    np.testing.assert_allclose(np.concatenate([c[1] for c in chunks], axis=1), ref,
                               atol=FORWARD_TOL[0], rtol=FORWARD_TOL[1])


@pytest.mark.parametrize("name", sorted(LORA_RUNS))
def test_lora_ranks_match_the_jax_mesh(runs, name):
    jax_results, _, out, _, lora_inits = runs
    jlogged, jparams, _ = jax_results[name]
    loss_tol, norm_tol, adapter_tol = LORA_TOL
    for rank in range(_world(LORA_RUNS[name][1])):
        logged = _rank(out / name, rank)["logged"]
        np.testing.assert_allclose(_curve(logged, "loss"), _curve(jlogged, "loss"),
                                   rtol=loss_tol)
        np.testing.assert_allclose(_curve(logged, "grad_norm"),
                                   _curve(jlogged, "grad_norm"), rtol=norm_tol)
    start = {"/".join(k.key for k in path): np.asarray(v) for path, v in
             jax.tree_util.tree_flatten_with_path(lora_inits[LORA_RUNS[name][0]])[0]}
    for path, value in _final_params(out / name).items():
        if path.startswith("base/"):
            assert np.array_equal(value, start[path]), f"base leaf {path} moved"
        else:
            np.testing.assert_allclose(value, jparams[path], atol=adapter_tol, err_msg=path)


@pytest.mark.parametrize("fault", sorted(LORA_FAULTS))
def test_each_lora_planted_fault_fails_the_jax_comparison(runs, fault):
    jax_results, _, out, _, _ = runs
    jlogged, jparams, _ = jax_results[LORA_FAULTS[fault]]
    case = out / f"fault_{fault}"
    worst = _misses(_rank(case, 0)["logged"], _final_params(case), jlogged, jparams,
                    LORA_TOL)
    assert worst > 1, f"{fault} went unseen: within {worst:.3g} of the tolerances"


def test_a_rule_that_moves_a_model_cut_is_refused_naming_a16(runs):
    """A rule that moves a leaf's model cut trains (it was refused before
    the reshard at read): ``wq`` stored cut over its head dim on each of
    the four ranks, read as its heads' block, as the JAX mesh reshards it."""
    jax_results, _, out, _, _ = runs
    jlogged, jparams, _ = jax_results["a16_fsdp_model"]
    assert _misses(_rank(out / "a16_fsdp_model", 0)["logged"],
                   _final_params(out / "a16_fsdp_model"), jlogged, jparams) <= 1
    for rank in range(4):
        cap = torch.load(out / "a16_fsdp_model" / f"grads{rank}.pt", weights_only=True)
        # stored as the rule says: fsdp on the hidden dim, model on the head dim
        assert cap["cuts"]["layers/attn/wq"] == [["fsdp", 1], ["model", 3]]


def test_two_slices_train_as_one(runs):
    """``num_slices: 2`` splits the ranks in order and changes no group: the
    losses and grad norms are bit-equal to one slice's."""
    _, _, out, _, _ = runs
    for rank in range(4):
        two = _rank(out / "slices2", rank)["logged"]
        one = _rank(out / "slices1", rank)["logged"]
        assert len(two) == STEPS and two == one


def _block(full: np.ndarray, cuts: list, coords: dict, sizes: dict) -> np.ndarray:
    """This rank's block of a full leaf under its cuts."""
    for axis, dim in cuts:
        n = full.shape[dim] // sizes[axis]
        full = np.take(full, range(coords[axis] * n, (coords[axis] + 1) * n), axis=dim)
    return full


@pytest.mark.parametrize("name", CAPTURED)
def test_first_step_grads_match_jax_leaf_by_leaf(runs, name):
    """Each rank's first-step grad of each leaf (its stored block, the
    rule's where one applies) against the block of JAX's grad of the first
    batch's loss: within 1e-4 relative and GRAD_TOL of the leaf's largest
    |grad| (``tests/test_torch_pipeline.py``'s limits)."""
    jax_results, _, out, _, _ = runs
    jgrads = jax_results[name][2]["grads"]
    sizes = normalize_axis_sizes(RUNS[name][1])
    for rank in range(_world(RUNS[name][1])):
        cap = torch.load(out / name / f"grads{rank}.pt", weights_only=True)
        assert set(cap["grads"]) == set(jgrads)
        for path, g in cap["grads"].items():
            want = _block(jgrads[path], cap["cuts"][path], cap["coords"], sizes)
            assert g.shape == want.shape, path
            if path.endswith(ZERO_GRAD_LEAVES):
                continue
            np.testing.assert_allclose(g.numpy(), want, rtol=GRAD_TOL[0],
                                       atol=GRAD_TOL[1] * np.abs(jgrads[path]).max(),
                                       err_msg=f"rank {rank} {path}")


def _factor_misses(case_dir: Path, want: dict) -> float:
    """The worst adafactor moment of a run's final state against JAX's, as
    a multiple of FACTOR_TOL (a shape that differs: inf)."""
    state = read_step(case_dir / "outputs" / "checkpoints" / str(STEPS))
    paths = ["/".join(p) for p, _ in flatten(state["params"])]
    worst = 0.0
    for field in ("v_row", "v_col", "v"):
        for path, t in zip(paths, state["opt_state"][field]):
            ref = want[field][path]
            if tuple(t.shape) != ref.shape:
                return float("inf")
            err = np.abs(t.numpy() - ref) / (FACTOR_TOL * np.abs(ref) + 1e-30)
            worst = max(worst, float(err.max()))
    return worst


@pytest.mark.parametrize("name", ADAFACTOR)
def test_adafactor_factors_match_the_jax_mesh(runs, name):
    """The final adafactor state: the factors of each factored leaf are
    the whole leaf's (JAX replicates them), an unfactored leaf's moment is
    the param's; both as JAX's after three steps (f32 means in other
    orders: FACTOR_TOL relative, as the losses)."""
    jax_results, _, out, _, _ = runs
    assert _factor_misses(out / name, jax_results[name][2]) <= 1
    state = read_step(out / name / "outputs" / "checkpoints" / str(STEPS))
    # the embedding, wi/wg and wo factor at hidden 128
    assert sum(t.numel() > 1 for t in state["opt_state"]["v_row"]) >= 3


@pytest.mark.parametrize("name,drop", [("af_fsdp", ()), ("a16_embed", ("partition_rules",))])
def test_a_two_rank_checkpoint_resumes_at_one_rank(runs, name, drop, tmp_path):
    """A run saved after one step at two ranks (adafactor under fsdp; the
    example's rule under model), resumed at one rank (without the rule)
    for the other two: the losses of the unbroken one-process run."""
    _, single, out, _, _ = runs
    art = tmp_path / "art"
    shutil.copytree(out / f"{name}_half", art)
    model = ALL_RUNS[name][0]
    spec = {k: v for k, v in _spec(name, {(model, False): str(out.parent / "fork" / model)})
            .items() if k not in drop}
    resumed = _one_process(art, {**spec, "parallelism": None}, ALL_RUNS[name][2], model)
    assert len(resumed) == STEPS - 1
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(_curve(resumed, key),
                                   _curve(single[name]["logged"], key)[1:], rtol=SELF_TOL[0])
