"""One rank of ``tests/test_torch_sharded_state.py``:

    python tests/fixtures/torch_sharded_worker.py <plan.json> <rank>

Joins a gloo group of ``plan["world"]`` ranks from the ``PLX_*`` env and
runs each case of the plan in that one group, on the CPU, writing
``<case dir>/rank<r>.pt``: this rank's blocks of the params, the optimizer
state and the extra state (by path), the mesh's sizes and this rank's
coordinates, each param leaf's cuts, and the largest tensor any op
allocated during the case's measured part (:class:`AllocationRecorder`).

Case kinds (``kind``):

- ``init``: the trainer's fresh init (``init_state``), measured;
- ``import``: ``import_params`` of ``case["import"]`` under the trainer's
  placement, measured;
- ``initial``: the runtime's ``_initial_params`` (an import, with LoRA
  adapters beside it, or a ``fork_from``);
- ``train_save``: ``restore_or_init``, then ``fit`` with checkpoints (the
  checkpointer's saves measured);
- ``restore``: ``restore_or_init`` from the checkpoints of the case named
  ``artifacts`` (another case's directory).

A case may plant a fault (``fault``): ``neighbour_coords`` (the placement
takes the next rank's coordinates) or ``seed_without_layer`` (a slice's
seed leaves out its indices), and patch its model's config
(``model_cfg``).
"""

from __future__ import annotations

import json
import os
import sys
from dataclasses import replace

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


class AllocationRecorder(TorchDispatchMode):
    """The largest tensor any op allocates while the mode is on: every op
    whose output holds storage none of its inputs holds (factory ops,
    copies, clones, out-of-place results); views and in-place ops
    allocate nothing. ``meta`` tensors have no storage and are not
    counted."""

    def __init__(self):
        super().__init__()
        self.largest, self.op = 0, None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        held = {t.untyped_storage().data_ptr() for t in tree_leaves((args, kwargs))
                if isinstance(t, torch.Tensor) and t.device.type != "meta"}
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor) or t.device.type == "meta":
                continue
            storage = t.untyped_storage()
            if storage.data_ptr() not in held and storage.nbytes() > self.largest:
                self.largest, self.op = storage.nbytes(), str(func)
        return out


class _Patches:
    def __init__(self):
        self._undo: list = []

    def setattr(self, obj, name, value):
        old = getattr(obj, name)
        self._undo.append(lambda: setattr(obj, name, old))
        setattr(obj, name, value)

    def setitem(self, obj, key, value):
        old = obj[key]
        self._undo.append(lambda: obj.__setitem__(key, old))
        obj[key] = value

    def undo(self):
        for fn in reversed(self._undo):
            fn()
        self._undo.clear()


def _plant(fault: str, mp: _Patches) -> None:
    from polyaxon_tpu_torch.parallel import blocks
    from polyaxon_tpu_torch.train.trainer import Trainer

    if fault == "neighbour_coords":
        placement = Trainer.placement

        def neighbour(self):
            place = placement(self)
            coords = self.mesh.coords((self.mesh.rank + 1) % self.mesh.size)
            return replace(place, coords=coords)

        mp.setattr(Trainer, "placement", neighbour)
    elif fault == "seed_without_layer":
        seed = blocks.slice_seed
        mp.setattr(blocks, "slice_seed", lambda s, key, index: seed(s, key, ()))
    else:
        raise ValueError(f"unknown fault {fault!r}")


def _flat(tree, prefix: str = "") -> dict:
    if tree is None:
        return {}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree.detach().clone()}


def _dump(trainer, state, recorder, case_dir: str, rank: int, **more) -> None:
    from polyaxon_tpu_torch.train.optimizers import opt_state_tree

    params = state.params if hasattr(state, "params") else state
    out = {"params": _flat(params), "coords": trainer.mesh.coords(),
           "sizes": dict(trainer.mesh.sizes), "cuts": trainer.placement().cuts,
           "largest": recorder.largest if recorder else 0,
           "largest_op": recorder.op if recorder else None, **more}
    if hasattr(state, "opt_state"):
        # each moment by its param's path
        trained = ["/".join(trainer._paths[i]) for i in trainer._opt_index]
        opt = opt_state_tree(state.opt_state)
        out["opt"] = {f"{name}/{trained[i]}": t.detach().clone()
                      for name, value in opt.items() if name != "count"
                      for i, t in enumerate(value)}
        out["extra"] = _flat(state.extra)
        out["step"] = int(state.step)
    torch.save(out, os.path.join(case_dir, f"rank{rank}.pt"))


def main() -> None:
    plan_path, rank = sys.argv[1], int(sys.argv[2])
    with open(plan_path) as f:
        plan = json.load(f)
    os.environ.update(PLX_COORDINATOR_ADDRESS=f"127.0.0.1:{plan['port']}",
                      PLX_NUM_PROCESSES=str(plan["world"]), PLX_PROCESS_ID=str(rank))
    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", 2)))
    from polyaxon_tpu_torch import parallel
    from polyaxon_tpu_torch.models import REGISTRY
    from polyaxon_tpu_torch.partition.convert import import_params
    from polyaxon_tpu_torch.runtime import builtin
    from polyaxon_tpu_torch.train.checkpoint import Checkpointer

    parallel.initialize(device="cpu", timeout_s=float(plan.get("timeout_s", 120)))
    for case in plan["cases"]:
        case_dir = os.path.join(plan["out"], case["name"])
        os.makedirs(case_dir, exist_ok=True)
        artifacts = os.path.join(plan["out"], case.get("artifacts", case["name"]))
        mp = _Patches()
        try:
            if case.get("fault"):
                _plant(case["fault"], mp)
            spec = case["spec"]
            if case.get("model_cfg"):
                family, cfg = REGISTRY[spec["model"]]
                mp.setitem(REGISTRY, spec["model"], (family, replace(cfg, **case["model_cfg"])))
            trainer, batches = builtin.build_trainer(spec, artifacts_dir=artifacts)
            kind, recorder = case["kind"], AllocationRecorder()
            if kind == "init":
                with recorder:
                    state = trainer.init_state(seed=0)
                _dump(trainer, state, recorder, case_dir, rank)
            elif kind == "import":
                imp = case["import"]
                with recorder:
                    params = import_params(imp["path"], trainer.cfg.model, device="cpu",
                                           layout=imp["layout"],
                                           placement=trainer.placement())
                _dump(trainer, params, recorder, case_dir, rank)
            elif kind == "initial":
                params, extra = builtin._initial_params(spec, trainer, trainer.cfg.model,
                                                        trainer.device)
                state = trainer.init_state_from_blocks(params, extra)
                _dump(trainer, state, None, case_dir, rank)
            elif kind == "train_save":
                state, _ = trainer.restore_or_init()
                save = Checkpointer.maybe_save

                def measured(self, *args, **kwargs):
                    with recorder:
                        return save(self, *args, **kwargs)

                mp.setattr(Checkpointer, "maybe_save", measured)
                state, _ = trainer.fit(batches, int(spec["steps"]), state=state)
                _dump(trainer, state, recorder, case_dir, rank)
            elif kind == "restore":
                state, step = trainer.restore_or_init()
                _dump(trainer, state, None, case_dir, rank, restored_step=step)
            else:
                raise ValueError(f"unknown case kind {kind!r}")
        finally:
            mp.undo()
        print(f"[worker {rank}] done {case['name']}", flush=True)
    parallel.shutdown()


if __name__ == "__main__":
    main()
