"""The port's mesh layer (``polyaxon_tpu_torch.parallel``) against the JAX
package's (``polyaxon_tpu.parallel``), in one process: the rendezvous env
(with torchrun's names where JAX honours its own), mesh sizes and errors
over N processes against ``build_mesh`` over N CPU devices (rank r at
device r's place), the logical sharding rules, every family's per-leaf
PartitionSpecs, each rank's batch rows against JAX's shard of the batch
(microbatches too) and its chunk of the sequence under ``context``, the
fsdp and model divisibility errors, the axes each family runs or refuses
with the JAX package's error, and adafactor's logical factors under fsdp
and model."""

from __future__ import annotations

from dataclasses import replace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP
from torch_threads import one_torch_thread  # noqa: F401

from polyaxon_tpu import parallel as jpar
from polyaxon_tpu.models import REGISTRY as JAX_REGISTRY
from polyaxon_tpu.train.tasks import task_for as jtask_for
from polyaxon_tpu_torch import parallel as tpar
from polyaxon_tpu_torch.models import REGISTRY
from polyaxon_tpu_torch.models.transformer import flatten
from polyaxon_tpu_torch.parallel.fsdp import leaf_dims
from polyaxon_tpu_torch.parallel.mesh import BATCH_AXES, mesh_sizes
from polyaxon_tpu_torch.train import data as tdata
from polyaxon_tpu_torch.train.tasks import refuse_unsupported_axes, task_for

_ENV_NAMES = ("PLX_COORDINATOR_ADDRESS", "PLX_NUM_PROCESSES", "PLX_PROCESS_ID",
              "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
              "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


@pytest.fixture
def clean_env(monkeypatch):
    for name in _ENV_NAMES:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


@pytest.mark.parametrize("env", [
    {},
    {"PLX_COORDINATOR_ADDRESS": "plx-a-master-0.hosts:8476", "PLX_NUM_PROCESSES": "4",
     "PLX_PROCESS_ID": "3"},
    {"PLX_NUM_PROCESSES": "2", "PLX_PROCESS_ID": "1"},
    {"PLX_COORDINATOR_ADDRESS": "10.0.0.1:1234", "PLX_NUM_PROCESSES": "1"},
])
def test_plx_env_parses_as_the_jax_package_does(clean_env, env):
    for k, v in env.items():
        clean_env.setenv(k, v)
    ours, theirs = tpar.process_info_from_env(), jpar.process_info_from_env()
    assert (ours.process_id, ours.num_processes, ours.coordinator_address) == \
        (theirs.process_id, theirs.num_processes, theirs.coordinator_address)
    assert ours.is_distributed == theirs.is_distributed
    assert ours.is_coordinator == theirs.is_coordinator


@pytest.mark.parametrize("torchrun,plx", [
    ({"MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "29500", "WORLD_SIZE": "8", "RANK": "5"},
     {"PLX_COORDINATOR_ADDRESS": "10.0.0.1:29500", "PLX_NUM_PROCESSES": "8",
      "PLX_PROCESS_ID": "5"}),
    # the PLX_* names win over torchrun's, as over JAX's
    ({"WORLD_SIZE": "8", "RANK": "5", "PLX_NUM_PROCESSES": "2", "PLX_PROCESS_ID": "1"},
     {"PLX_NUM_PROCESSES": "2", "PLX_PROCESS_ID": "1"}),
])
def test_torchrun_names_stand_in_for_the_jax_names(clean_env, torchrun, plx):
    """The port honours torchrun's raw names where the JAX module honours
    JAX's: a torchrun env reads as its PLX_* twin reads to JAX."""
    for k, v in torchrun.items():
        clean_env.setenv(k, v)
    ours = tpar.process_info_from_env()
    for k in torchrun:
        clean_env.delenv(k)
    for k, v in plx.items():
        clean_env.setenv(k, v)
    theirs = jpar.process_info_from_env()
    assert (ours.process_id, ours.num_processes, ours.coordinator_address) == \
        (theirs.process_id, theirs.num_processes, theirs.coordinator_address)


def test_local_rank_names_the_device(clean_env):
    clean_env.setenv("LOCAL_RANK", "3")
    assert tpar.local_rank() == 3
    clean_env.delenv("LOCAL_RANK")
    assert tpar.local_rank(tpar.ProcessInfo(5, 8, "h:1")) == (
        5 % torch.cuda.device_count() if torch.cuda.is_available() else 0)


@pytest.mark.parametrize("args", [("plx-x-master-0.plx-x-hosts", 8476, 4, 0),
                                  ("127.0.0.1", 29500, 2, 1)])
def test_rendezvous_env_is_the_jax_packages(args):
    assert tpar.rendezvous_env(*args) == jpar.rendezvous_env(*args)


def test_initialize_is_a_no_op_for_one_process_and_needs_a_coordinator(clean_env):
    info = tpar.initialize(tpar.ProcessInfo(0, 1, None))
    assert not torch.distributed.is_initialized() and not info.is_distributed
    with pytest.raises(RuntimeError, match="no PLX_COORDINATOR_ADDRESS"):
        tpar.initialize(tpar.ProcessInfo(0, 2, None))


MESH_CASES = [
    (None, 1), (None, 4), ({"data": 2}, 2), ({"fsdp": 2}, 2), ({"data": 2, "fsdp": 2}, 4),
    ({"fsdp": 2}, 8), ({"model": 2}, 8), ({"data": 1}, 4), ({"fsdp": 4, "model": 2}, 8),
    # errors
    ({"data": 2}, 1), ({"fsdp": 3}, 8), ({"data": 2, "model": 3}, 8), ({"tensor": 2}, 2),
]


@pytest.mark.parametrize("spec,n", MESH_CASES)
def test_mesh_sizes_and_errors_are_build_meshs(spec, n):
    """Over n processes as JAX's over n devices: the same axis sizes, rank
    r at device r's coordinates, or the same error."""
    try:
        jmesh = jpar.build_mesh(spec, devices=jax.devices()[:n])
    except ValueError as e:
        with pytest.raises(ValueError) as ours:
            mesh_sizes(spec, n)
        assert str(ours.value) == str(e)
        return
    sizes = mesh_sizes(spec, n)
    assert sizes == dict(jmesh.shape)
    mesh = tpar.Mesh(sizes=sizes)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for r in range(n):
        pos = np.argwhere(ids == r)[0]
        assert mesh.coords(r) == dict(zip(jpar.MESH_AXES, map(int, pos)))
    assert tpar.mesh_axis_size(mesh, "data", "fsdp") == jpar.mesh_axis_size(
        jmesh, "data", "fsdp")


def test_one_process_meshes_have_no_group():
    mesh = tpar.build_mesh({"fsdp": 1})
    assert mesh.size == 1 and not mesh.distributed and not mesh.sharded
    assert mesh.declared == {"fsdp"}
    with pytest.raises(ValueError, match="1 devices not divisible by num_slices=2"):
        tpar.build_mesh(None, num_slices=2)


def test_the_rules_are_the_jax_packages():
    assert tpar.MESH_AXES == jpar.MESH_AXES
    assert tpar.DEFAULT_RULES == jpar.DEFAULT_RULES
    ours, theirs = tpar.ShardingRules(), jpar.ShardingRules()
    names = [n for n, _ in jpar.DEFAULT_RULES] + [None]
    for name in names:
        assert ours.mesh_axes(name) == theirs.mesh_axes(name)
    for axes in [("batch", "seq"), ("layers", "embed", "heads", "head_dim"),
                 ("vocab", "embed"), (None, "embed"), ()]:
        assert tuple(ours.spec(axes)) == tuple(theirs.spec(axes))
    for kw in [dict(embed=None), dict(layers="stage"), dict(new_axis="model")]:
        o, t = ours.override(**kw), theirs.override(**kw)
        assert o.rules == t.rules
        assert tuple(o.spec(tuple(kw))) == tuple(t.spec(tuple(kw)))
    with pytest.raises(KeyError, match="No sharding rule"):
        ours.mesh_axes("nope")


@pytest.mark.parametrize("model", ["llama-tiny", "bert-tiny", "vit-tiny", "resnet18-cifar"])
def test_each_familys_spec_tree_is_the_jax_tasks(model):
    family, cfg = REGISTRY[model]
    jfamily, jcfg = JAX_REGISTRY[model]
    ours = flatten(task_for(family, cfg).param_specs(tpar.ShardingRules()))
    theirs = jax.tree_util.tree_flatten_with_path(
        jtask_for(jfamily, jcfg).param_specs(jpar.ShardingRules()),
        is_leaf=lambda x: isinstance(x, JP))[0]
    theirs = {tuple(k.key for k in path): tuple(spec) for path, spec in theirs}
    assert {path: tuple(spec) for path, spec in ours} == theirs
    # the embed-sharded dim is the one fsdp splits: a stacked layer leaf's
    # second dim, the token table's second, the head's first
    if family == "lm":
        specs = dict(ours)
        assert specs[("layers", "attn", "wq")][1] == "fsdp"
        assert specs[("embed", "tokens")][1] == "fsdp"


@pytest.mark.parametrize("spec,n", [({"data": 2}, 2), ({"fsdp": 2}, 2),
                                    ({"data": 2, "fsdp": 2}, 4), ({"fsdp": 4}, 4)])
@pytest.mark.parametrize("k", [1, 2])
def test_each_rank_gets_the_rows_jax_gives_its_device(spec, n, k):
    """JAX reshapes the global batch to (k, B/k) and shards each microbatch
    over the batch axes; rank r's rows are device r's, microbatch-major."""
    batch = 16
    jmesh = jpar.build_mesh(spec, devices=jax.devices()[:n])
    sharding = NamedSharding(jmesh, JP(None, ("data", "fsdp", "expert")))
    index_map = sharding.devices_indices_map((k, batch // k))
    mesh = tpar.Mesh(sizes=mesh_sizes(spec, n))
    for device, (_, cols) in index_map.items():
        rows = [i * (batch // k) + c for i in range(k)
                for c in range(*cols.indices(batch // k))]
        ours = tdata.local_rows(batch, k, mesh.index(BATCH_AXES, device.id),
                                mesh.axis_size(*BATCH_AXES))
        assert list(ours) == rows


def test_a_microbatch_that_does_not_split_over_the_ranks_raises():
    with pytest.raises(ValueError, match="does not split over 4 ranks"):
        tdata.local_rows(8, 4, 0, 4)


@pytest.mark.parametrize("kind", ["synthetic-lm", "synthetic-mlm", "synthetic-image",
                                  "tokens-file"])
def test_a_ranks_stream_holds_its_rows_of_the_global_batch(kind, tmp_path):
    path = None
    if kind == "tokens-file":
        path = str(tmp_path / "tokens.npy")
        np.save(path, np.random.default_rng(0).integers(0, 256, 4096).astype(np.uint16))
    common = dict(kind=kind, batch_size=8, seq_len=16, vocab_size=256, image_size=8,
                  num_classes=10, path=path, seed=3)
    rows = tdata.local_rows(8, 2, 1, 2)
    whole = tdata.make_batches(tdata.DataConfig(**common))
    mine = tdata.make_batches(tdata.DataConfig(**common, rows=rows))
    for _ in range(2):
        full, part = next(whole), next(mine)
        for name, t in full.items():
            assert torch.equal(part[name], t[list(rows)]), name


def test_an_fsdp_dim_that_does_not_divide_raises_as_jax_does():
    jmesh = jpar.build_mesh({"fsdp": 2}, devices=jax.devices()[:2])
    with pytest.raises(ValueError) as theirs:
        jax.device_put(np.zeros((3, 4), np.float32), NamedSharding(jmesh, JP("fsdp")))
    with pytest.raises(ValueError) as ours:
        leaf_dims(tpar.PartitionSpec("fsdp"), torch.zeros(3, 4), 2)
    want = "implies that the global size of its dimension 0 should be divisible by 2, " \
           "but it is equal to 3 (full shape: (3, 4))"
    assert want in str(theirs.value) and want in str(ours.value)


def test_adafactor_under_fsdp_is_refused_naming_its_item():
    """adafactor runs on a mesh that cuts its leaves (it was refused before
    its factors had a layout): the factors are the whole leaf's, factored
    by its logical shape, while the unfactored moments take the param's
    block. A hidden-128 llama's ``mlp/wi`` ``[L, 128, 128]`` factors, but
    its ``[L, 128, 64]`` model block alone would not."""
    from polyaxon_tpu_torch.train import OptimizerConfig, Trainer, TrainerConfig

    wide = replace(REGISTRY["llama-tiny"][1], hidden=128, mlp_dim=128)
    cfg = TrainerConfig(model=wide, accelerator=None,
                        optimizer=OptimizerConfig(name="adafactor"))
    sharded = tpar.Mesh(sizes=mesh_sizes({"fsdp": 1}, 1), distributed=True,
                        declared=frozenset({"fsdp"}))
    assert sharded.sharded
    split = tpar.Mesh(sizes=mesh_sizes({"model": 2}, 2), distributed=True,
                      declared=frozenset({"model"}))
    assert split.tp and not split.sharded
    for mesh in (sharded, split):
        trainer = Trainer(cfg, device="cpu", mesh=mesh)
        state = trainer.init_state(seed=0)
        paths = ["/".join(p) for p, _ in flatten(state.params)]
        i = paths.index("layers/mlp/wi")
        block = tuple(flatten(state.params)[i][1].shape)
        assert block == ((2, 128, 64) if mesh is split else (2, 128, 128))
        assert tuple(state.opt_state.v_row[i].shape) == (2, 128)
        assert tuple(state.opt_state.v_col[i].shape) == (2, 128)
        assert tuple(state.opt_state.v[i].shape) == (1,)
        # the final norm's scale does not factor: its v is the param's block
        j = paths.index("final_norm/scale")
        assert state.opt_state.v[j].shape == flatten(state.params)[j][1].shape


@pytest.mark.parametrize("spec,n", [({"context": 2}, 2), ({"data": 2, "context": 2}, 4),
                                    ({"model": 2, "context": 2}, 4),
                                    ({"fsdp": 2, "model": 2}, 4), ({"context": 4}, 4)])
def test_each_rank_gets_the_sequence_chunk_jax_gives_its_device(spec, n):
    """The LM streams' P(batch, "context"): rank r keeps the rows and the
    chunk of the sequence that JAX's device r holds, and ``rank_of`` is
    the inverse of ``coords``."""
    batch, seq = 8, 32
    jmesh = jpar.build_mesh(spec, devices=jax.devices()[:n])
    index_map = NamedSharding(jmesh, JP(("data", "fsdp", "expert"), "context")
                              ).devices_indices_map((batch, seq))
    mesh = tpar.Mesh(sizes=mesh_sizes(spec, n), distributed=True)
    for device, (rows, cols) in index_map.items():
        r = device.id
        assert mesh.rank_of(mesh.coords(r)) == r
        ours_rows = tdata.local_rows(batch, 1, mesh.index(BATCH_AXES, r),
                                     mesh.axis_size(*BATCH_AXES))
        assert list(ours_rows) == list(range(*rows.indices(batch)))
        cut = tdata.local_cols(batch, seq, mesh.coords(r)["context"], mesh.sizes["context"])
        assert (cut or (0, seq)) == cols.indices(seq)[:2]


def test_a_sequence_that_does_not_cut_over_context_raises_as_jax_does():
    jmesh = jpar.build_mesh({"context": 2}, devices=jax.devices()[:2])
    with pytest.raises(ValueError) as theirs:
        jax.device_put(np.zeros((8, 33), np.int32),
                       NamedSharding(jmesh, JP(("data", "fsdp", "expert"), "context")))
    with pytest.raises(ValueError) as ours:
        tdata.local_cols(8, 33, 0, 2)
    want = "implies that the global size of its dimension 1 should be divisible by 2, " \
           "but it is equal to 33 (full shape: (8, 33))"
    assert want in str(theirs.value) and want in str(ours.value)


def test_kv_heads_that_do_not_divide_over_model_raise_as_jax_does():
    """llama-tiny's 2 kv heads over a model axis of 4: JAX's NamedSharding
    of ``wk`` refuses it, and so does the port's leaf check."""
    cfg = REGISTRY["llama-tiny"][1]
    specs = task_for("lm", cfg).param_specs(tpar.ShardingRules())
    wk = torch.zeros(cfg.num_layers, cfg.hidden, cfg.kv_heads, cfg.hd)
    jmesh = jpar.build_mesh({"model": 4}, devices=jax.devices()[:4])
    with pytest.raises(ValueError) as theirs:
        jax.device_put(np.zeros(tuple(wk.shape), np.float32),
                       NamedSharding(jmesh, JP(*specs["layers"]["attn"]["wk"])))
    with pytest.raises(ValueError) as ours:
        leaf_dims(specs["layers"]["attn"]["wk"], wk, 4, "model")
    want = "implies that the global size of its dimension 2 should be divisible by 4, " \
           "but it is equal to 2 (full shape: (2, 64, 2, 16))"
    assert want in str(theirs.value) and want in str(ours.value)


@pytest.mark.parametrize("model,axes,error,match", [
    # a ResNet's compute is replicated over model and context: both run
    ("resnet18-cifar", {"model": 2}, None, None),
    ("resnet18-cifar", {"context": 2}, None, None),
    # the JAX package's own error: 17 tokens do not cut over 2 context ranks
    ("vit-tiny", {"context": 2}, ValueError, "not evenly divisible"),
    # the JAX package's own errors: a ResNet has no layered trunk to
    # pipeline (its Trainer), llama-tiny's 2 layers do not cut into 3 stages
    # (its gpipe_trunk)
    ("resnet18-cifar", {"stage": 2}, NotImplementedError, "trunk"),
    ("llama-tiny", {"stage": 3}, ValueError, "2 layers do not divide over 3 stages"),
])
def test_what_a_family_does_not_shard_over_raises(model, axes, error, match):
    sizes = tpar.normalize_axis_sizes(axes)
    if error is None:
        refuse_unsupported_axes(REGISTRY[model][1], sizes)
        return
    with pytest.raises(error, match=match):
        refuse_unsupported_axes(REGISTRY[model][1], sizes)


@pytest.mark.parametrize("model,axes", [("llama-tiny", {"model": 2, "context": 2}),
                                        ("bert-tiny", {"context": 2}),
                                        ("vit-tiny", {"model": 2}),
                                        ("resnet18-cifar", {"data": 2, "fsdp": 2}),
                                        ("llama-tiny", {"stage": 2, "model": 2}),
                                        ("bert-tiny", {"expert": 2}),
                                        ("llama-moe-tiny", {"stage": 2, "expert": 2}),
                                        ("vit-tiny", {"stage": 2})])
def test_what_a_family_shards_over_is_taken(model, axes):
    refuse_unsupported_axes(REGISTRY[model][1], tpar.normalize_axis_sizes(axes))


@pytest.mark.parametrize("kind", ["synthetic-lm", "synthetic-mlm", "tokens-file"])
def test_a_ranks_stream_holds_its_sequence_chunk(kind, tmp_path):
    """Under context, a rank's inputs, labels and mask are its chunk of its
    rows of the global batch (the labels the global next tokens, so a
    chunk's last label is the next chunk's first input)."""
    path = None
    if kind == "tokens-file":
        path = str(tmp_path / "tokens.npy")
        np.save(path, np.random.default_rng(0).integers(0, 256, 4096).astype(np.uint16))
    common = dict(kind=kind, batch_size=8, seq_len=16, vocab_size=256, path=path, seed=3)
    rows = tdata.local_rows(8, 1, 1, 2)
    cols = tdata.local_cols(8, 16, 1, 4)
    assert cols == (4, 8)
    whole = tdata.make_batches(tdata.DataConfig(**common))
    mine = tdata.make_batches(tdata.DataConfig(**common, rows=rows, cols=cols))
    for _ in range(2):
        full, part = next(whole), next(mine)
        for name, t in full.items():
            assert torch.equal(part[name], t[list(rows)][:, 4:8]), name
