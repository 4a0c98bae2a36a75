"""ResNet and ViT under the port's model and context parallelism on gloo
groups, against the JAX package's SPMD trainer on CPU meshes of the same
shape: ResNet (f32, batch 4) under ``{model: 2}`` and ``{data: 2,
context: 2}`` (the compute replicated) and ViT on 24-pixel images (nine
patches and the CLS) under ``{context: 2}``, with each rank's first-step
grads leaf by leaf; ResNet grads summed over model (a planted fault) must
fail. The cases, helpers and tolerances are ``tests/test_torch_tp_cp.py``'s;
these run in a file of their own, with their own groups and JAX runs, so
that they run beside that file's on another test worker.
"""

from __future__ import annotations

import pytest
import test_torch_tp_cp as base
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return base.build_runs(tmp_path_factory, base.VISION_RUNS, base.VISION_FAULTS)


@pytest.mark.parametrize("name", base.VISION_RUNS)
def test_tp_cp_ranks_match_the_jax_mesh(runs, name):
    base.test_tp_cp_ranks_match_the_jax_mesh(runs, name)


@pytest.mark.parametrize("name", base.VISION_RUNS)
def test_tp_cp_ranks_match_one_process(runs, name):
    base.test_tp_cp_ranks_match_one_process(runs, name)


@pytest.mark.parametrize("fault", base.VISION_FAULTS)
def test_each_tp_cp_planted_fault_fails_the_jax_comparison(runs, fault):
    base.test_each_tp_cp_planted_fault_fails_the_jax_comparison(runs, fault)


@pytest.mark.parametrize("name", base.VISION_RUNS)
def test_first_step_grads_match_jax_leaf_by_leaf(runs, name):
    base.test_first_step_grads_match_jax_leaf_by_leaf(runs, name)
