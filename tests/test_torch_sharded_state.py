"""The port's sharded state on the CPU: init, import, save and restore that
never build a leaf whole on a rank.

One gloo group of four ranks (``tests/fixtures/torch_sharded_worker.py``)
runs every case; meshes of two ranks run with ``data`` absorbing the rest.
Each rank's blocks are held, bit for bit, against the blocks the mesh's
own ``shard`` cuts from the whole tree of one process:

- init: llama-tiny, llama-moe-tiny, gpt2-tiny (tied head), bert-tiny,
  vit-tiny and resnet18-cifar over ``{fsdp: 2}``, ``{model: 2}``,
  ``{fsdp: 2, model: 2}``, ``{expert: 2, fsdp: 2}``, ``{stage: 2}`` and
  the embed rule; params, optimizer state and ``extra``. Two planted faults
  (a rank that takes its neighbour's coordinates, a slice seed without the
  layer index) must fail the same comparison;
- an allocation recorder (a ``TorchDispatchMode``) over init, import and
  save: no rank allocates a tensor larger than its largest block or one
  slice (one layer of a stacked leaf, one expert of one layer, a leaf
  without layers);
- import: hf-llama and flat sources in npy-dir and safetensors containers
  under ``{fsdp: 2}``, ``{model: 2}`` and the embed rule: each rank's block
  is the block of the whole import and the JAX package's ``import_params``
  shard at the same index on a 2-device CPU mesh;
- checkpoints: a step saved at ``{fsdp: 2, model: 2}`` restores at world 1
  and at ``{fsdp: 4}``, one saved at world 1 restores at ``{fsdp: 2,
  model: 2}``, a one-file (``state.pt``) step restores at both, a torn rank
  file is skipped, and serving's ``checkpoint:`` and ``fork_from:`` read a
  sharded step.

Every comparison is exact: a block is a copy of bytes.
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from polyaxon_tpu_torch.models import REGISTRY
from polyaxon_tpu_torch.models.transformer import flatten
from polyaxon_tpu_torch.parallel.mesh import Mesh
from polyaxon_tpu_torch.partition.convert import export_hf_llama, import_params, save_flat
from polyaxon_tpu_torch.runtime.builtin import build_trainer, run_builtin
from polyaxon_tpu_torch.serve.runtime import load_params
from polyaxon_tpu_torch.train.checkpoint import CheckpointConfig, Checkpointer, read_step
from polyaxon_tpu_torch.train.tasks import task_for

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "fixtures" / "torch_sharded_worker.py"
WORLD = 4
BASE = {"platform": "cpu", "steps": 2, "batch_size": 4, "seq_len": 16, "checkpoint": False}
EMBED_RULE = [["embed/tokens$", [None, "fsdp"]]]
#: a user rule that cuts an adapter: the imported run's adapters must be
#: this rank's blocks of a fresh init's, as the trainer's own init builds them
LORA_RULE = [["lora/layers/attn/wq/a$", [None, "fsdp", None]]]
LORA = {"rank": 4, "alpha": 8}
CKPT = {"save_interval_steps": 1, "async_save": True}

#: init case -> (model, parallelism, partition rules)
INIT_CASES = {
    "llama_fsdp": ("llama-tiny", {"fsdp": 2}, None),
    "llama_model": ("llama-tiny", {"model": 2}, None),
    "llama_fsdp_model": ("llama-tiny", {"fsdp": 2, "model": 2}, None),
    "llama_stage": ("llama-tiny", {"stage": 2}, None),
    "llama_embed_rule": ("llama-tiny", {"fsdp": 2}, EMBED_RULE),
    "moe_expert_fsdp": ("llama-moe-tiny", {"expert": 2, "fsdp": 2}, None),
    "gpt2_fsdp": ("gpt2-tiny", {"fsdp": 2}, None),
    "gpt2_model": ("gpt2-tiny", {"model": 2}, None),
    "bert_fsdp_model": ("bert-tiny", {"fsdp": 2, "model": 2}, None),
    "vit_fsdp": ("vit-tiny", {"fsdp": 2}, None),
    "vit_model": ("vit-tiny", {"model": 2}, None),
    "vit_stage": ("vit-tiny", {"stage": 2}, None),
    "resnet_fsdp": ("resnet18-cifar", {"fsdp": 2}, None),
}
FAULTS = {"neighbour_coords": "llama_fsdp_model", "seed_without_layer": "llama_stage"}
#: a llama-tiny deep enough that a stacked leaf outgrows every slice and
#: every block: a whole leaf built anywhere shows in the recorder
DEEP = {"num_layers": 8}
IMPORT_MESHES = {"fsdp": ({"fsdp": 2}, None), "model": ({"model": 2}, None),
                 "embed_rule": ({"fsdp": 2}, EMBED_RULE)}
IMPORT_SOURCES = {"hf_npy": ("hf", "hf-llama"), "hf_safetensors": ("hf.safetensors", "hf-llama"),
                  "flat_npy": ("flat", "flat"), "flat_safetensors": ("flat.safetensors", "flat")}
SAVE_SPEC = {**BASE, "model": "llama-tiny", "parallelism": {"fsdp": 2, "model": 2},
             "checkpoint": CKPT}
#: four ranks over {fsdp: 2}: the two ranks of data coordinate 1 hold no block
#: that a lower rank does not
SAVE_FSDP2 = {**SAVE_SPEC, "steps": 1, "parallelism": {"fsdp": 2}}


def _spec(model: str, para: dict, rules=None, **more) -> dict:
    spec = {**BASE, "model": model, "parallelism": para, **more}
    if REGISTRY[model][0] in ("vit", "resnet"):
        del spec["seq_len"]  # the image models have no sequence to set
    if rules:
        spec["partition_rules"] = rules
    return spec


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write_safetensors(npy_dir: Path, path: Path) -> None:
    from safetensors.numpy import save_file

    src = {str(p.relative_to(npy_dir))[:-len(".npy")]: np.load(p)
           for p in npy_dir.rglob("*.npy")}
    save_file({k.replace(os.sep, "/"): np.ascontiguousarray(v) for k, v in src.items()},
              str(path))


def _one_file_step(ck_dir: Path, src: Path, step: int) -> None:
    """A step in the one-file layout earlier saves wrote: ``state.pt`` (the
    whole tree) and its manifest."""
    tree = read_step(src)
    (ck_dir / str(step)).mkdir(parents=True)
    torch.save(_contiguous(tree), ck_dir / str(step) / "state.pt")
    Checkpointer(CheckpointConfig(directory=str(ck_dir))).wait()  # backfills the manifest


def _contiguous(tree):
    if isinstance(tree, dict):
        return {k: _contiguous(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_contiguous(v) for v in tree]
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The sources and world-1 checkpoints the cases read, then one 4-rank
    group running every case; returns the cases' directory."""
    root = tmp_path_factory.mktemp("sharded")
    out = root / "cases"
    cfg = REGISTRY["llama-tiny"][1]
    params = task_for("lm", cfg).init(7, "cpu")[0]
    export_hf_llama(params, cfg, str(root / "hf"))
    save_flat(params, str(root / "flat"))
    _write_safetensors(root / "hf", root / "hf.safetensors")
    _write_safetensors(root / "flat", root / "flat.safetensors")
    # a world-1 run that saves steps 1 and 2 in the sharded layout
    before = os.environ.get("PLX_ARTIFACTS_PATH")
    os.environ["PLX_ARTIFACTS_PATH"] = str(out / "ck1")
    try:
        run_builtin({**BASE, "model": "llama-tiny", "checkpoint": CKPT})
    finally:
        if before is None:
            os.environ.pop("PLX_ARTIFACTS_PATH", None)
        else:
            os.environ["PLX_ARTIFACTS_PATH"] = before
    ck1 = out / "ck1" / "outputs" / "checkpoints"
    _one_file_step(out / "onefile" / "outputs" / "checkpoints", ck1 / "2", 2)

    cases = [{"name": name, "kind": "init", "spec": _spec(*c)} for name, c in INIT_CASES.items()]
    cases += [{"name": f"fault_{f}", "kind": "init", "fault": f,
               "spec": _spec(*INIT_CASES[run])} for f, run in FAULTS.items()]
    cases.append({"name": "deep", "kind": "init", "model_cfg": DEEP,
                  "spec": _spec("llama-tiny", {"fsdp": 2})})
    cases += [{"name": f"import_{src}_{mesh}", "kind": "import",
               "spec": _spec("llama-tiny", *IMPORT_MESHES[mesh]),
               "import": {"path": str(root / IMPORT_SOURCES[src][0]),
                          "layout": IMPORT_SOURCES[src][1]}}
              for src in IMPORT_SOURCES for mesh in IMPORT_MESHES]
    cases.append({"name": "import_lora", "kind": "initial",
                  "spec": _spec("llama-tiny", {"fsdp": 2}, EMBED_RULE + LORA_RULE,
                                lora=LORA,
                                **{"import": {"path": str(root / "hf"),
                                              "layout": "hf-llama"}})})
    cases.append({"name": "fork", "kind": "initial",
                  "spec": _spec("llama-tiny", {"fsdp": 2, "model": 2},
                                fork_from={"path": str(ck1)})})
    cases.append({"name": "save4", "kind": "train_save", "spec": SAVE_SPEC})
    cases.append({"name": "save4_fsdp2", "kind": "train_save", "spec": SAVE_FSDP2})
    restore = {**SAVE_SPEC, "steps": 4}
    cases += [{"name": "restore4_fsdp4", "kind": "restore", "artifacts": "save4",
               "spec": {**restore, "parallelism": {"fsdp": 4}}},
              {"name": "restore4_from1", "kind": "restore", "artifacts": "ck1", "spec": restore},
              {"name": "restore4_onefile", "kind": "restore", "artifacts": "onefile",
               "spec": restore}]
    plan = root / "plan.json"
    plan.write_text(json.dumps({"world": WORLD, "port": _free_port(), "out": str(out),
                                "timeout_s": 120, "cases": cases}))
    env = {k: v for k, v in os.environ.items() if not k.startswith("PLX_")}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    logs = [root / f"worker-{r}.log" for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(plan), str(r)], env=env,
                              stdout=open(logs[r], "w"), stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    try:
        codes = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert codes == [0] * WORLD, [log.read_text()[-3000:] for log in logs]
    return out


def _ranks(out: Path, name: str) -> list:
    return [torch.load(out / name / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _block(whole: torch.Tensor, cuts, sizes: dict, coords: dict) -> torch.Tensor:
    """The block of ``whole`` at ``coords`` as the mesh cuts it."""
    mesh = Mesh(sizes=dict(sizes))
    mesh.rank = mesh.rank_of(coords)
    return mesh.shard(whole, tuple(tuple(c) for c in cuts))


def _flat(tree, prefix: str = "") -> dict:
    return {prefix + "/".join(p): t for p, t in flatten(tree)} if tree else {}


def _mismatches(rank: dict, whole: dict, key: str = "params", prefix: str = "") -> list:
    """The paths whose block differs from the whole leaf's block at the
    rank's coordinates (dtype, shape or a bit)."""
    bad = []
    for path, t in rank[key].items():
        want = _block(whole[path], rank["cuts"].get(prefix + path, ()), rank["sizes"],
                      rank["coords"])
        if t.dtype != want.dtype or t.shape != want.shape or not torch.equal(t, want):
            bad.append(path)
    if set(rank[key]) != set(whole):
        bad.append(f"paths {sorted(set(rank[key]) ^ set(whole))}")
    return bad


def _whole_init(model: str, **cfg_changes):
    family, cfg = REGISTRY[model]
    if cfg_changes:
        from dataclasses import replace

        cfg = replace(cfg, **cfg_changes)
    params, extra = task_for(family, cfg).init(0, "cpu")
    return _flat(params), _flat(extra), task_for(family, cfg)


def _slice_bytes(task) -> int:
    """The largest slice of the model's init laws, in bytes."""
    from polyaxon_tpu_torch.partition.rules import tree_paths

    return max(int(np.prod(law.shape[law.lead:])) * torch.empty((), dtype=law.dtype).element_size()
               for _, law in tree_paths(task.param_laws()))


def _block_bytes(rank: dict) -> int:
    return max(t.numel() * t.element_size() for key in ("params", "opt", "extra")
               for t in rank.get(key, {}).values())


@pytest.mark.parametrize("name", sorted(INIT_CASES))
def test_each_ranks_init_is_the_block_of_the_one_rank_init(group, name):
    whole, extra, _ = _whole_init(INIT_CASES[name][0])
    ranks = _ranks(group, name)
    cut = 0
    for rank in ranks:
        assert _mismatches(rank, whole) == []
        assert rank["step"] == 0 and _mismatches(rank, extra, "extra") == []
        # AdamW's moments: zeros, one per param leaf, each the leaf's block
        for key, t in rank["opt"].items():
            path = key.split("/", 1)[1]
            assert t.shape == rank["params"][path].shape and not t.any(), key
        assert len(rank["opt"]) == 2 * len(whole)
        cut += sum(t.numel() != whole[p].numel() for p, t in rank["params"].items())
    if name != "resnet_fsdp":  # ResNet replicates every leaf
        assert cut > 0, "no leaf was cut"


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_planted_init_fault_fails_the_comparison(group, fault):
    whole, _, _ = _whole_init(INIT_CASES[FAULTS[fault]][0])
    bad = [_mismatches(rank, whole) for rank in _ranks(group, f"fault_{fault}")]
    assert any(bad), f"{fault} went unseen"


def test_the_recorder_sees_no_leaf_built_whole_at_init(group):
    """llama-tiny at 8 layers over ``{fsdp: 2}``: its stacked mlp leaves are
    the largest tensors of the tree, larger than any block or slice; no op
    of a rank's init allocates one."""
    whole, _, task = _whole_init("llama-tiny", **DEEP)
    largest_leaf = max(t.numel() * t.element_size() for t in whole.values())
    for rank in _ranks(group, "deep"):
        assert _mismatches(rank, whole) == []
        bound = max(_block_bytes(rank), _slice_bytes(task))
        assert rank["largest"] <= bound < largest_leaf, (rank["largest"], rank["largest_op"])


@pytest.mark.parametrize("phase", ["init", "import", "save"])
def test_no_rank_allocates_more_than_a_block_or_a_slice(group, phase):
    names = {"init": sorted(INIT_CASES) + ["deep"],
             "import": [f"import_{s}_{m}" for s in IMPORT_SOURCES for m in IMPORT_MESHES],
             "save": ["save4"]}[phase]
    for name in names:
        model = INIT_CASES[name][0] if name in INIT_CASES else "llama-tiny"
        task = _whole_init(model, **(DEEP if name == "deep" else {}))[2]
        for rank in _ranks(group, name):
            bound = max(_block_bytes(rank), _slice_bytes(task))
            assert 0 < rank["largest"] <= bound, (name, rank["largest"], rank["largest_op"],
                                                  bound)


def _jax_import(path: str, layout: str, para: dict, rules) -> dict:
    """The JAX package's import onto a 2-device CPU mesh: {leaf path:
    {index: shard}}."""
    import jax

    from polyaxon_tpu.models import REGISTRY as JAX_REGISTRY
    from polyaxon_tpu.parallel.mesh import build_mesh
    from polyaxon_tpu.partition import convert as jconvert
    from polyaxon_tpu.partition.builtins import abstract_params_for_config, rules_for_config
    from polyaxon_tpu.partition.rules import (
        match_partition_rules, overlay_partition_rules, parse_rules, path_str,
    )

    jcfg = JAX_REGISTRY["llama-tiny"][1]
    mesh = build_mesh(para, devices=jax.devices()[:2])
    abstract = abstract_params_for_config("lm", jcfg)
    specs = match_partition_rules(rules_for_config("lm", jcfg), abstract)
    if rules:
        specs = overlay_partition_rules(parse_rules(rules), abstract, specs)
    shardings = jax.tree.map(lambda s: jax.sharding.NamedSharding(mesh, s), specs)
    tree = jconvert.import_params(path, jcfg, mesh, layout=layout, shardings=shardings)
    out = {}
    for kp, arr in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[path_str(k.key for k in kp)] = {
            tuple(s.indices(n)[:2] for s, n in zip(shard.index, arr.shape)):
                np.asarray(shard.data) for shard in arr.addressable_shards}
    return out


@pytest.mark.parametrize("src", sorted(IMPORT_SOURCES))
@pytest.mark.parametrize("mesh", sorted(IMPORT_MESHES))
def test_each_ranks_import_is_the_block_of_the_whole_import_and_jaxs(group, src, mesh):
    file, layout = IMPORT_SOURCES[src]
    path = str(group.parent / file)
    cfg = REGISTRY["llama-tiny"][1]
    whole = _flat(import_params(path, cfg, device="cpu", layout=layout))
    jax_blocks = _jax_import(path, layout, *IMPORT_MESHES[mesh])
    seen: dict = {}
    for rank in _ranks(group, f"import_{src}_{mesh}"):
        assert _mismatches(rank, whole) == []
        for leaf, t in rank["params"].items():
            cuts = rank["cuts"].get(leaf, ())
            start = [0] * t.dim()
            size = list(whole[leaf].shape)
            for axis, dim in cuts:
                size[dim] //= rank["sizes"][axis]
                start[dim] += rank["coords"][axis] * size[dim]
            index = tuple((s, s + n) for s, n in zip(start, size))
            np.testing.assert_array_equal(t.numpy(), jax_blocks[leaf][index], err_msg=leaf)
            seen.setdefault(leaf, set()).add(index)
    # the ranks hold every shard of the JAX layout, and no other block
    assert seen == {leaf: set(shards) for leaf, shards in jax_blocks.items()}


def test_an_import_with_lora_reads_the_base_by_block(group):
    from polyaxon_tpu_torch.partition.lora import LoRAConfig, init_lora

    cfg = REGISTRY["llama-tiny"][1]
    whole_base = import_params(str(group.parent / "hf"), cfg, device="cpu", layout="hf-llama")
    whole = _flat(whole_base)
    whole_lora = _flat(init_lora(whole_base, LoRAConfig.from_spec(LORA), seed=0, device="cpu"))
    for rank in _ranks(group, "import_lora"):
        base = {p[len("base/"):]: t for p, t in rank["params"].items() if p.startswith("base/")}
        lora = {p[len("lora/"):]: t for p, t in rank["params"].items() if p.startswith("lora/")}
        assert lora and all(p.endswith(("/a", "/b")) for p in lora)
        assert _mismatches({**rank, "params": base}, whole, prefix="base/") == []
        assert _mismatches({**rank, "params": lora}, whole_lora, prefix="lora/") == []
        # the embed rule's storage: the token table cut over fsdp on its embed dim
        assert rank["cuts"]["base/embed/tokens"] == (("fsdp", 1),)
        assert rank["cuts"]["lora/layers/attn/wq/a"] == (("fsdp", 1),)


def _restored_whole(ck_root: Path, spec: dict):
    """A world-1 trainer's restore of the run's newest step: (flat params,
    flat moments by ``mu/i``/``nu/i``, step)."""
    trainer, _ = build_trainer({**spec, "parallelism": None}, artifacts_dir=str(ck_root))
    state, step = trainer.restore_or_init()
    params = _flat(state.params)
    opt = {f"{name}/{path}": t for name in ("mu", "nu")
           for path, t in zip(params, getattr(state.opt_state, name))}
    return params, opt, step


def _opt_cuts(rank: dict) -> dict:
    return {key: rank["cuts"].get(key.split("/", 1)[1], ()) for key in rank["opt"]}


def _check_restored(ranks: list, params: dict, opt: dict) -> None:
    for rank in ranks:
        assert _mismatches(rank, params) == []
        cuts = _opt_cuts(rank)
        assert _mismatches({**rank, "cuts": cuts}, opt, "opt") == []


def test_a_step_saved_at_four_ranks_restores_at_one(group):
    params, opt, step = _restored_whole(group / "save4", SAVE_SPEC)
    assert step == 2
    # each rank's state at the end of its run is the block of the restore
    _check_restored(_ranks(group, "save4"), params, opt)
    index = json.loads((group / "save4" / "outputs" / "checkpoints" / "2" / "index.json")
                       .read_text())
    assert index["world"] == WORLD and len(index["files"]) == WORLD
    # a replicated leaf is written once, a cut one once per block
    assert len(index["leaves"]["params/final_norm/scale"]["blocks"]) == 1
    assert len(index["leaves"]["params/layers/attn/wq"]["blocks"]) == 4


def test_a_rank_that_writes_no_block_leaves_only_its_record(group):
    params, opt, step = _restored_whole(group / "save4_fsdp2", SAVE_FSDP2)
    assert step == 1
    _check_restored(_ranks(group, "save4_fsdp2"), params, opt)
    step_dir = group / "save4_fsdp2" / "outputs" / "checkpoints" / "1"
    index = json.loads((step_dir / "index.json").read_text())
    assert len(list(step_dir.glob("shard-*.json"))) == WORLD
    assert sorted(p.name for p in step_dir.glob("shard-*.pt")) == sorted(index["files"])
    assert len(index["files"]) == 2


def test_a_step_saved_at_four_ranks_restores_on_another_mesh(group):
    params, opt, _ = _restored_whole(group / "save4", SAVE_SPEC)
    ranks = _ranks(group, "restore4_fsdp4")
    assert {r["restored_step"] for r in ranks} == {2}
    _check_restored(ranks, params, opt)


@pytest.mark.parametrize("name", ["restore4_from1", "restore4_onefile"])
def test_a_world_one_step_restores_at_four_ranks(group, name):
    artifacts = group / ("ck1" if name == "restore4_from1" else "onefile")
    params, opt, step = _restored_whole(artifacts, SAVE_SPEC)
    ranks = _ranks(group, name)
    assert step == 2 and {r["restored_step"] for r in ranks} == {2}
    _check_restored(ranks, params, opt)


def test_a_one_file_step_restores_at_world_one(group):
    one, _, _ = _restored_whole(group / "onefile", SAVE_SPEC)
    sharded, _, _ = _restored_whole(group / "ck1", SAVE_SPEC)
    assert (group / "onefile" / "outputs" / "checkpoints" / "2" / "state.pt").exists()
    assert one.keys() == sharded.keys()
    assert all(torch.equal(one[p], sharded[p]) for p in one)


def test_a_torn_or_missing_rank_file_is_skipped(group, tmp_path):
    """Step 2 of the 4-rank save without rank 1's file, or with it cut
    short: the restore walks back to step 1."""
    for damage in ("missing", "torn"):
        art = tmp_path / damage
        shutil.copytree(group / "save4", art)
        victim = art / "outputs" / "checkpoints" / "2" / "shard-00001.pt"
        if damage == "missing":
            victim.unlink()
        else:
            with open(victim, "r+b") as f:
                f.truncate(victim.stat().st_size // 2)
        ck = Checkpointer(CheckpointConfig(directory=str(art / "outputs" / "checkpoints")),
                          read_only=True)
        assert not ck.verify_step(2) and ck.complete_steps_desc() == [1]
        _, _, step = _restored_whole(art, SAVE_SPEC)
        assert step == 1


def test_serving_reads_a_sharded_step(group):
    params, _, _ = _restored_whole(group / "save4", SAVE_SPEC)
    served, prov = load_params({"checkpoint": str(group / "save4" / "outputs" / "checkpoints")},
                               REGISTRY["llama-tiny"][1], torch.device("cpu"))
    assert prov["restored_step"] == 2
    assert _flat(served).keys() == params.keys()
    assert all(torch.equal(t, params[p]) for p, t in _flat(served).items())


def test_fork_from_reads_this_ranks_blocks_of_a_sharded_step(group):
    params, _, _ = _restored_whole(group / "ck1", SAVE_SPEC)
    for rank in _ranks(group, "fork"):
        assert _mismatches(rank, params) == []
        assert any(t.numel() < params[p].numel() for p, t in rank["params"].items())
