"""The port's partition engine (``polyaxon_tpu_torch.partition``) against the
JAX package's (``polyaxon_tpu.partition``), in one process on the CPU.

- the five built-in rule sets are JAX's, pattern for pattern and spec for
  spec;
- ``match_partition_rules``, ``overlay_partition_rules``, ``parse_rules``
  and ``validate_rules_against`` give JAX's specs on the cases of
  ``tests/test_partition.py`` and raise JAX's error class with JAX's
  message on every malformed rule;
- the audit passes over every zoo model and catches a leaf no rule
  matches;
- ``build_plan``'s rows and summary equal JAX's for every zoo model at
  ``{fsdp: 2, model: 2}`` on 8 devices, alone, with ``lora`` and with a
  user rule;
- ``validate_builtin_spec`` raises what JAX's raises on each malformed
  ``lora``, ``import`` and ``partition_rules`` block;
- the multislice rank order is the JAX mesh's device order, and both
  packages refuse a mesh whose data x fsdp the slices do not divide.

Exact equality throughout: the engine is shape math, with no arithmetic.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from polyaxon_tpu import parallel as jpar
from polyaxon_tpu import partition as jpart
from polyaxon_tpu.partition import plan as jplan
from polyaxon_tpu.partition.lora import LoRATargetError as JLoRATargetError
from polyaxon_tpu_torch import parallel as tpar
from polyaxon_tpu_torch import partition as tpart
from polyaxon_tpu_torch.models import REGISTRY
from polyaxon_tpu_torch.parallel.mesh import PartitionSpec as TP
from polyaxon_tpu_torch.partition import plan as tplan
from polyaxon_tpu_torch.partition.lora import LoRATargetError

RULE_SETS = ("TRANSFORMER_RULES", "TRANSFORMER_MOE_RULES", "VIT_RULES", "RESNET_RULES",
             "LORA_RULES")
USER_RULES = [["embed/tokens$", [None, "fsdp"]], ["attn/w[qkv]$", [None, None, "model", None]]]
PLAN_MESH = dict(parallelism={"fsdp": 2, "model": 2}, num_devices=8)


def _spec_tree(tree):
    """A spec tree (either package's) as nested dicts of plain tuples."""
    if isinstance(tree, dict):
        return {k: _spec_tree(v) for k, v in tree.items()}
    return tuple(tree)


def _error(fn, *args, **kwargs):
    """(class name, message) of what ``fn`` raises."""
    with pytest.raises(Exception) as exc:
        fn(*args, **kwargs)
    return type(exc.value).__name__, str(exc.value)


# -- the rule sets ---------------------------------------------------------------------


@pytest.mark.parametrize("name", RULE_SETS)
def test_the_builtin_rule_sets_are_the_jax_packages(name):
    ours, theirs = getattr(tpart, name), getattr(jpart, name)
    assert [(p, tuple(s)) for p, s in ours] == [(p, tuple(s)) for p, s in theirs]


@pytest.mark.parametrize("model", sorted(REGISTRY))
def test_rules_for_and_the_abstract_tree_are_the_jax_packages(model):
    assert [(p, tuple(s)) for p, s in tpart.rules_for(model)] == \
        [(p, tuple(s)) for p, s in jpart.rules_for(model)]
    ours = [(p, tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for p, t in tpart.tree_paths(tpart.abstract_params_for(model))]
    theirs = [(p, tuple(t.shape), str(np.dtype(t.dtype)))
              for p, t in jpart.tree_paths(jpart.abstract_params_for(model))]
    assert ours == theirs


# -- the engine on tests/test_partition.py's cases -------------------------------------

# (rules, tree's leaves): each matched by both engines
MATCH_CASES = {
    "first_match_wins": ([("a/w$", ("model", None)), ("w$", (None, "model"))],
                         {"a/w": (4, 4)}),
    "order_flipped": ([("w$", (None, "model")), ("a/w$", ("model", None))],
                      {"a/w": (4, 4)}),
    "nested_search": ([("attn/wq$", (None, "fsdp", "model"))],
                      {"enc/layers/attn/wq": (2, 4, 4)}),
    "scalars_replicate": ([("w$", ("model",))], {"step": (), "one": (1,), "w": (4, 4)}),
    "short_spec": ([("w$", ("fsdp",))], {"w": (4, 4, 4)}),
    "unmatched": ([("^a$", ())], {"a": (4, 4), "b": (8,), "c": (2, 2)}),
    "bad_regex": ([("a/(w$", ())], {"a": (2,)}),
    "overlong_spec": ([("w$", ("model", None, "fsdp"))], {"w": (4, 4)}),
    "not_a_pair": ([("only-a-pattern",)], {"a": (2,)}),
}


def _nest(flat: dict, make) -> dict:
    tree: dict = {}
    for path, shape in flat.items():
        node = tree
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = make(shape)
    return tree


def _both(case):
    rules, leaves = MATCH_CASES[case]
    jrules = [(r[0], JP(*r[1])) if len(r) == 2 else r for r in rules]
    trules = [(r[0], TP(*r[1])) if len(r) == 2 else r for r in rules]
    jtree = _nest(leaves, lambda s: jax.ShapeDtypeStruct(s, jnp.float32))
    ttree = _nest(leaves, lambda s: torch.empty(s, device="meta"))
    return jrules, jtree, trules, ttree


@pytest.mark.parametrize("case", sorted(MATCH_CASES))
def test_match_partition_rules_is_the_jax_packages(case):
    jrules, jtree, trules, ttree = _both(case)
    try:
        want = _spec_tree(jpart.match_partition_rules(jrules, jtree))
    except Exception as e:  # noqa: BLE001 - the JAX package's verdict is the oracle
        assert _error(tpart.match_partition_rules, trules, ttree) == \
            (type(e).__name__, str(e))
        if hasattr(e, "paths"):
            with pytest.raises(tpart.UnmatchedParamError) as exc:
                tpart.match_partition_rules(trules, ttree)
            assert exc.value.paths == e.paths
        return
    assert _spec_tree(tpart.match_partition_rules(trules, ttree)) == want


@pytest.mark.parametrize("case", ["first_match_wins", "scalars_replicate", "overlong_spec",
                                  "bad_regex"])
def test_overlay_partition_rules_is_the_jax_packages(case):
    jrules, jtree, trules, ttree = _both(case)
    base = {"a": ("fsdp",), "b": ("model",), "w": ("fsdp", "model"), "step": (),
            "one": ("fsdp",)}

    def build(tree, make):
        return {k: build(v, make) if isinstance(v, dict) else make(*base.get(k, ("data",)))
                for k, v in tree.items()}

    try:
        want = _spec_tree(jpart.overlay_partition_rules(jrules, jtree, build(jtree, JP)))
    except Exception as e:  # noqa: BLE001
        assert _error(tpart.overlay_partition_rules, trules, ttree, build(ttree, TP)) == \
            (type(e).__name__, str(e))
        return
    assert _spec_tree(tpart.overlay_partition_rules(trules, ttree, build(ttree, TP))) == want


PARSE_CASES = {
    "forms": [["norm", None], ["bias$", "replicated"], ["x$", "replicate"],
              ["wq$", [None, "fsdp", ["data", "expert"]]]],
    "unknown_axis": [["wq$", ["tensor"]]],
    "not_a_pair": [["only-a-pattern"]],
    "a_string": "attn: model",
    "pattern_not_a_string": [[3, None]],
    "bad_regex": [["attn/(wq$", None]],
    "spec_a_number": [["wq$", 3]],
    "nested_null": [["wq$", [[None, "fsdp"]]]],
    "entry_a_number": [["wq$", [1]]],
    "none": None,
}


@pytest.mark.parametrize("case", sorted(PARSE_CASES))
def test_parse_rules_is_the_jax_packages(case):
    raw = PARSE_CASES[case]
    try:
        want = [(p, tuple(s)) for p, s in jpart.parse_rules(raw)]
    except Exception as e:  # noqa: BLE001
        assert _error(tpart.parse_rules, raw) == (type(e).__name__, str(e))
        return
    got = tpart.parse_rules(raw)
    assert [(p, tuple(s)) for p, s in got] == want
    assert tpart.parse_rules(got) == got  # idempotent
    assert tpart.rules_to_jsonable(got) == jpart.rules_to_jsonable(jpart.parse_rules(raw))


@pytest.mark.parametrize("rules", [
    [["attn/wz$", None]],                         # matches nothing: nearest paths
    [["attn/wq$", [None, "fsdp", "model", None, "data"]]],   # one entry too many
    [["attn/wq$", [None, "fsdp", "model", None]], ["mlp/", None]],
])
def test_validate_rules_against_is_the_jax_packages(rules):
    jpaths = jpart.tree_paths(jpart.abstract_params_for("llama-tiny"))
    tpaths = tpart.tree_paths(tpart.abstract_params_for("llama-tiny"))
    try:
        jpart.validate_rules_against(jpart.parse_rules(rules), jpaths)
    except Exception as e:  # noqa: BLE001
        assert _error(tpart.validate_rules_against, tpart.parse_rules(rules), tpaths) == \
            (type(e).__name__, str(e))
        return
    tpart.validate_rules_against(tpart.parse_rules(rules), tpaths)


# -- the audit ---------------------------------------------------------------------------


def test_the_audit_covers_every_zoo_model():
    report = tpart.audit()
    assert sorted(report) == sorted(REGISTRY)
    assert all(r["status"] == "ok" for r in report.values())
    few = ["llama-tiny", "llama-moe-tiny", "gpt2-tiny", "bert-tiny", "vit-tiny",
           "resnet18-cifar"]
    assert {m: report[m] for m in few} == jpart.audit(few)


def test_the_audit_catches_a_leaf_no_rule_matches(monkeypatch):
    from polyaxon_tpu_torch.partition import builtins as tb

    orig = tb.abstract_params_for_config

    def with_extra(family, cfg):
        tree = orig(family, cfg)
        if family == "lm":
            tree = dict(tree, brand_new_block={"w": torch.empty((8, 8), device="meta")})
        return tree

    monkeypatch.setattr(tplan, "abstract_params_for_config", with_extra)
    with pytest.raises(tpart.UnmatchedParamError) as exc:
        tpart.audit(["llama-tiny"])
    assert "brand_new_block/w" in str(exc.value)


def test_the_audit_entry_point_exits_zero():
    from polyaxon_tpu_torch.partition.__main__ import main

    assert main(["llama-tiny", "resnet18-cifar"]) == 0
    assert main(["no-such-model"]) == 1


# -- build_plan --------------------------------------------------------------------------


@pytest.mark.parametrize("model", sorted(REGISTRY))
def test_build_plan_is_the_jax_packages(model):
    family = REGISTRY[model][0]
    variants = [{}, {"partition_rules": USER_RULES}]
    if family in ("lm", "mlm"):
        variants += [{"lora": {"rank": 4, "alpha": 8.0}},
                     {"lora": True, "partition_rules": USER_RULES}]
    for kw in variants:
        ours = tpart.build_plan(model, **PLAN_MESH, **kw)
        theirs = jpart.build_plan(model, **PLAN_MESH, **kw)
        assert ours == theirs, kw
    assert tpart.format_plan(ours) == jpart.format_plan(theirs)


def test_plan_axis_sizes_absorb_capacity_into_data():
    for para, n in (({"model": 2}, 8), ({"fsdp": 2, "model": 2}, 8), (None, 4),
                    ({"data": 2}, 8), ({"model": 3}, 8)):
        assert tplan.plan_axis_sizes(para, n) == jplan.plan_axis_sizes(para, n)


# -- validate_builtin_spec ---------------------------------------------------------------

BAD_SPECS = {
    "lora_target_matches_nothing": {"lora": {"rank": 4, "target": "attn/nope$"}},
    "lora_target_unfactorable": {"lora": {"target": "attn_norm/scale$"}},
    "lora_target_bad_regex": {"lora": {"target": "attn/(wq"}},
    "lora_not_a_mapping": {"lora": "yes"},
    "lora_on_resnet": {"model": "resnet18-cifar", "lora": {"rank": 4}},
    "unknown_model": {"model": "llama-9t", "partition_rules": [["attn/wq$", None]]},
    "rule_bad_regex": {"partition_rules": [["attn/(wq$", None]]},
    "rule_matches_nothing": {"partition_rules": [["attn/wqq$", None]]},
    "rule_unknown_axis": {"partition_rules": [["attn/wq$", ["tensor"]]]},
    "rule_too_long": {"partition_rules": [["attn/wq$", [None, None, None, None, "fsdp"]]]},
    "rule_over_adapters_unmatched": {"lora": True,
                                     "partition_rules": [["^lora/mlp/", None]]},
    "import_not_a_mapping": {"import": "/x"},
    "import_no_path": {"import": {"layout": "flat"}},
    "import_on_vit": {"model": "vit-tiny", "import": {"path": "/x"}},
    "import_bad_layout": {"import": {"path": "/x", "layout": "orbax"}},
    "import_hf_layout_on_gpt2": {"model": "gpt2-tiny",
                                 "import": {"path": "/x", "layout": "hf-llama"}},
    "import_bad_dtype": {"import": {"path": "/x", "dtype": "bfloat17"}},
    "import_key_map_bad_regex": {"import": {"path": "/x", "key_map": [["[", "x"]]}},
    "import_key_map_not_a_pair": {"import": {"path": "/x", "key_map": [["a"]]}},
    "import_transpose_axes": {"import": {"path": "/x", "transpose": [["wq$", ["a", "b"]]]}},
}


@pytest.mark.parametrize("case", sorted(BAD_SPECS))
def test_validate_builtin_spec_raises_what_the_jax_package_raises(case):
    spec = {"model": "llama-tiny", **BAD_SPECS[case]}
    want = _error(jpart.validate_builtin_spec, spec)
    assert _error(tpart.validate_builtin_spec, spec) == want


def test_valid_blocks_pass_both():
    spec = {"model": "llama-tiny", "lora": {"rank": 4},
            "partition_rules": [["^lora/layers/attn/wq/", None], ["attn/wq$", [None, "fsdp"]]],
            "import": {"path": "/x", "layout": "hf-llama", "dtype": "bfloat16",
                       "key_map": [["^a$", "b"]], "transpose": [["wq$", [1, 0]]]}}
    assert tpart.needs_validation(spec) and jpart.needs_validation(spec)
    assert not tpart.needs_validation({"model": "llama-tiny"})
    jpart.validate_builtin_spec(spec)
    tpart.validate_builtin_spec(spec)
    with pytest.raises(LoRATargetError):
        tpart.validate_builtin_spec({"model": "llama-tiny", "lora": {"target": "x$"}})
    with pytest.raises(JLoRATargetError):
        jpart.validate_builtin_spec({"model": "llama-tiny", "lora": {"target": "x$"}})


# -- multislice rank order ---------------------------------------------------------------


@pytest.mark.parametrize("para", [{"data": 2, "fsdp": 2, "model": 2}, {"fsdp": 4, "model": 2}])
def test_the_multislice_rank_order_is_the_jax_meshs(para):
    devices = jax.devices()[:8]
    jmesh = jpar.build_mesh(para, devices=devices, num_slices=2)
    mesh = tpar.build_mesh(para, world_size=8, rank=0, num_slices=2)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    slices = tpar.device_slice_ids(8, 2)
    assert slices == jpar.device_slice_ids(devices, 2)
    for r in range(8):
        pos = np.argwhere(ids == r)[0]
        assert mesh.coords(r) == dict(zip(jpar.MESH_AXES, map(int, pos)))
    # every model group inside one slice; data x fsdp spans both
    for r in range(8):
        c = mesh.coords(r)
        peers = [mesh.rank_of({**c, "model": m}) for m in range(mesh.sizes["model"])]
        assert len({slices[p] for p in peers}) == 1
    assert set(slices) == {0, 1}


@pytest.mark.parametrize("para,world", [({"model": 2}, 2), ({"model": 8}, 8),
                                        ({"data": 3}, 3)])
def test_both_packages_refuse_what_the_slices_cannot_split(para, world):
    want = _error(jpar.build_mesh, para, devices=jax.devices()[:world], num_slices=2)
    assert _error(tpar.build_mesh, para, world_size=world, rank=0, num_slices=2) == want
