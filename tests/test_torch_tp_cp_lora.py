"""LoRA under the port's data, fsdp, model and context parallelism on
gloo groups, against the JAX package's ``LoRATask`` with
``frozen_base_optimizer`` on CPU meshes of the same shape: two ranks of
llama-tiny under ``{data: 2}``, ``{fsdp: 2}`` (each layer's delta added
after its gather), ``{model: 2}`` (with the A16 rule too) and ``{context:
2}``, and bert-tiny under ``{model: 2}`` (each model rank merging its
block's delta, the adapters' grads summed over model); a planted fault
leaving those grads unsummed must fail. The cases, helpers and tolerances
(1e-6 relative on losses and grad norms, 1e-5 absolute on the final
adapters, the base bit-equal to its start) are
``tests/test_torch_tp_cp.py``'s; these run in a file of their own, with
their own group and JAX runs, so that they run beside that file's on
another test worker.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import test_torch_tp_cp as base
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return base.build_runs(tmp_path_factory, lora_runs=tuple(sorted(base.LORA_RUNS)),
                           lora_faults=tuple(sorted(base.LORA_FAULTS)))


@pytest.mark.parametrize("name", sorted(base.LORA_RUNS))
def test_lora_ranks_match_the_jax_mesh(runs, name):
    jax_results, _, out, _, lora_inits = runs
    jlogged, jparams, _ = jax_results[name]
    loss_tol, norm_tol, adapter_tol = base.LORA_TOL
    for rank in range(base._world(base.LORA_RUNS[name][1])):
        logged = base._rank(out / name, rank)["logged"]
        np.testing.assert_allclose(base._curve(logged, "loss"),
                                   base._curve(jlogged, "loss"), rtol=loss_tol)
        np.testing.assert_allclose(base._curve(logged, "grad_norm"),
                                   base._curve(jlogged, "grad_norm"), rtol=norm_tol)
    start = {"/".join(k.key for k in path): np.asarray(v) for path, v in
             jax.tree_util.tree_flatten_with_path(lora_inits[base.LORA_RUNS[name][0]])[0]}
    for path, value in base._final_params(out / name).items():
        if path.startswith("base/"):
            assert np.array_equal(value, start[path]), f"base leaf {path} moved"
        else:
            np.testing.assert_allclose(value, jparams[path], atol=adapter_tol, err_msg=path)


@pytest.mark.parametrize("fault", sorted(base.LORA_FAULTS))
def test_each_lora_planted_fault_fails_the_jax_comparison(runs, fault):
    jax_results, _, out, _, _ = runs
    jlogged, jparams, _ = jax_results[base.LORA_FAULTS[fault]]
    case = out / f"fault_{fault}"
    worst = base._misses(base._rank(case, 0)["logged"], base._final_params(case), jlogged,
                         jparams, base.LORA_TOL)
    assert worst > 1, f"{fault} went unseen: within {worst:.3g} of the tolerances"
