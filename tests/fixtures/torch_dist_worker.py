"""One rank of the port's multi-process CPU tests
(``tests/test_torch_distributed.py``, ``tests/test_torch_tp_cp.py``):

    python tests/fixtures/torch_dist_worker.py <plan.json> <rank>

Joins a gloo group of ``plan["world"]`` ranks from the ``PLX_*`` env, as a
pod of a distributed run would, then runs each case of the plan in that
one group through ``run_builtin`` (``platform: cpu``), with the case's
directory as ``PLX_ARTIFACTS_PATH``, and writes
``<case dir>/rank<r>.json``: the logged losses and grad norms and the
summary. A case may plant a fault (``fault``), poison one rank's batch
(``nan``), run in f32 (``f32``) or with a model config's ``seq_parallel``
(``seq_parallel``); instead of training, it may restore a run's checkpoint
(its own, or ``artifacts``: another case's) into a sharded state and save
this rank's shards (``restore_shards``), or run one forward of the given
params and tokens on this rank's chunk and save its logits (``forward``).
"""

from __future__ import annotations

import json
import os
import sys
from dataclasses import replace


def _plant(fault: str, rank: int, mp) -> None:
    """The faults the tests must see, each a wrong reduction of its own."""
    from polyaxon_tpu_torch.parallel import mesh as mesh_mod
    from polyaxon_tpu_torch.train import data as data_mod

    if fault == "mlm_rank_mean":
        # each rank's mean over its own mask count, then the ranks' average
        mp.setattr(mesh_mod.Mesh, "batch_count",
                   lambda self, c: c.detach().float() * self.axis_size(*mesh_mod.BATCH_AXES))
    elif fault == "bn_rank_stats":
        # batch statistics of each rank's rows alone
        mp.setattr(mesh_mod.Mesh, "batch_mean", lambda self, s, n: s / n)
    elif fault == "rank_local_microbatches":
        # microbatch i = the i-th chunk of the rank's contiguous rows
        mp.setattr(data_mod, "local_rows", lambda b, k, i, n: tuple(
            range(i * b // n, (i + 1) * b // n)))
    elif fault == "bias_before_sum":
        # a row-parallel layer's replicated bias added to each rank's partial
        # product, so that the sum over model counts it once per rank
        import torch

        from polyaxon_tpu_torch.models import transformer

        def before(y, w, bias, mesh):
            out = torch.matmul(y, w) + (0 if bias is None else bias)
            return out if mesh is None else mesh.from_model(out)

        mp.setattr(transformer, "_row_parallel", before)
    elif fault == "local_positions":
        # each context rank's positions start at 0 instead of its chunk's
        from polyaxon_tpu_torch.models import transformer

        mp.setattr(transformer, "_seq_offset", lambda s, mesh=None: 0)
    elif fault == "norm_counts_replicated":
        # every leaf's squares summed over model, replicated ones too
        from polyaxon_tpu_torch.train.trainer import Trainer

        whole = Trainer._whole_sums
        mp.setattr(Trainer, "_whole_sums", lambda self, dims, mdims, sums: whole(
            self, dims, [0 if d is None else d for d in mdims], sums))
    else:
        raise ValueError(f"unknown fault {fault!r}")


def _poison(at: int, once: bool, mp) -> None:
    """NaN in this rank's images of batch ``at`` (``once``: only the first
    time the batch is drawn, as a transient fault)."""
    from polyaxon_tpu_torch import train

    make = train.make_batches
    drawn = []

    def poisoned(cfg):
        inner = make(cfg)

        def batch(i):
            b = inner._make(i)
            if i == at and not (once and drawn):
                drawn.append(i)
                b["images"][0, 0, 0, 0] = float("nan")
            return b

        return train.BatchStream(batch)

    mp.setattr(train, "make_batches", poisoned)


def _configure(name: str, mp, **changes) -> None:
    """The registry's config of ``name`` with ``changes`` for this case."""
    from polyaxon_tpu_torch.models import REGISTRY

    family, cfg = REGISTRY[name]
    mp.setitem(REGISTRY, name, (family, replace(cfg, **changes)))


def _restore_shards(spec: dict, artifacts: str, case_dir: str, rank: int) -> dict:
    import torch

    from polyaxon_tpu_torch.models.transformer import flatten
    from polyaxon_tpu_torch.runtime.builtin import build_trainer

    trainer, _ = build_trainer(spec, artifacts_dir=artifacts)
    state, step = trainer.restore_or_init()
    shards = {"params/" + "/".join(p): t for p, t in flatten(state.params)}
    for name in ("mu", "nu"):
        for i, t in enumerate(getattr(state.opt_state, name)):
            shards[f"{name}/{i}"] = t
    torch.save(shards, os.path.join(case_dir, f"rank{rank}.pt"))
    coords = trainer.mesh.coords()
    return {"restored_step": step, "fsdp_index": coords["fsdp"],
            "model_index": coords["model"]}


def _forward(case: dict, case_dir: str, rank: int) -> dict:
    """One forward of ``case["params"]`` (a saved param tree) on this
    rank's chunk of ``case["tokens"]`` (a saved [batch, seq] array) over
    the case's mesh; saves the chunk's f32 logits."""
    import numpy as np
    import torch

    from polyaxon_tpu_torch.models import REGISTRY, transformer
    from polyaxon_tpu_torch.parallel import build_mesh
    from polyaxon_tpu_torch.train.data import local_cols

    cfg = REGISTRY[case["spec"]["model"]][1]
    mesh = build_mesh(case["spec"]["parallelism"])
    params = torch.load(case["params"], weights_only=True)
    tokens = torch.from_numpy(np.load(case["tokens"]).astype(np.int64))
    cols = local_cols(*tokens.shape, mesh.seq_index, mesh.cp) or (0, tokens.shape[1])
    with torch.no_grad():
        hidden = transformer.apply_hidden(params, tokens[:, cols[0]:cols[1]], cfg, mesh=mesh)
        w, vocab_major = transformer.head_weights(params, cfg)
        w = w.to(cfg.dtype)
        logits = torch.matmul(hidden, w.t() if vocab_major else w).float()
    torch.save(logits, os.path.join(case_dir, f"rank{rank}.pt"))
    return {"cols": list(cols)}


class _Patches:
    """monkeypatch's setattr/setitem, undone after each case."""

    def __init__(self):
        self._undo = []

    def setattr(self, obj, name, value):
        self._undo.append((setattr, obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def setitem(self, obj, key, value):
        self._undo.append((obj.__setitem__, key, obj[key], None))
        obj[key] = value

    def undo(self):
        for fn, a, b, c in reversed(self._undo):
            fn(a, b, c) if fn is setattr else fn(a, b)
        self._undo.clear()


def main() -> None:
    plan_path, rank = sys.argv[1], int(sys.argv[2])
    with open(plan_path) as f:
        plan = json.load(f)
    os.environ.update(PLX_COORDINATOR_ADDRESS=f"127.0.0.1:{plan['port']}",
                      PLX_NUM_PROCESSES=str(plan["world"]), PLX_PROCESS_ID=str(rank))
    import torch

    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", 2)))
    from polyaxon_tpu_torch import parallel
    from polyaxon_tpu_torch.runtime.builtin import run_builtin

    parallel.initialize(device="cpu", timeout_s=float(plan.get("timeout_s", 120)))
    for case in plan["cases"]:
        case_dir = os.path.join(plan["out"], case["name"])
        os.makedirs(case_dir, exist_ok=True)
        os.environ["PLX_ARTIFACTS_PATH"] = case_dir
        mp = _Patches()
        try:
            if case.get("fault"):
                _plant(case["fault"], rank, mp)
            if case.get("nan") and rank == case["nan"]["rank"]:
                _poison(case["nan"]["step"], case["nan"].get("once", False), mp)
            if case.get("f32"):
                import torch

                _configure(case["spec"]["model"], mp, dtype=torch.float32)
            if case.get("seq_parallel"):
                _configure(case["spec"]["model"], mp, seq_parallel=case["seq_parallel"])
            if case.get("restore_shards"):
                artifacts = os.path.join(plan["out"], case.get("artifacts", case["name"]))
                result = _restore_shards(case["spec"], artifacts, case_dir, rank)
            elif case.get("forward"):
                result = _forward(case, case_dir, rank)
            else:
                logged = []
                for spec in case["runs"] if "runs" in case else [case["spec"]]:
                    summary = run_builtin(spec, track=lambda i, m: logged.append(
                        {"step": i, "loss": m["loss"], "grad_norm": m["grad_norm"]}))
                result = {"logged": logged, "summary": summary}
        finally:
            mp.undo()
        with open(os.path.join(case_dir, f"rank{rank}.json"), "w") as f:
            json.dump(result, f)
        print(f"[worker {rank}] done {case['name']}", flush=True)
    parallel.shutdown()


if __name__ == "__main__":
    main()
