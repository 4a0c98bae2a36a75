"""One rank of the port's multi-process CPU tests
(``tests/test_torch_distributed.py``, ``tests/test_torch_tp_cp.py``,
``tests/test_torch_moe.py``, ``tests/test_torch_pipeline.py``):

    python tests/fixtures/torch_dist_worker.py <plan.json> <rank>

Joins a gloo group of ``plan["world"]`` ranks from the ``PLX_*`` env, as a
pod of a distributed run would, then runs each case of the plan in that
one group through ``run_builtin`` (``platform: cpu``), with the case's
directory as ``PLX_ARTIFACTS_PATH``, and writes
``<case dir>/rank<r>.json``: the logged losses and grad norms and the
summary. A case may plant a fault (``fault``), poison one rank's batch
(``nan``), run in f32 (``f32``), with a model config's ``seq_parallel``
(``seq_parallel``) or other fields (``model_cfg``); instead of training, it may restore a run's checkpoint
(its own, or ``artifacts``: another case's) into a sharded state and save
this rank's shards (``restore_shards``), run one forward of the given
params and tokens on this rank's chunk and save its logits (``forward``),
expect ``run_builtin`` to refuse the spec and record its message
(``expect_error``),
or run one forward and backward of the trunk (``grads``: the hidden
states, aux and the grads of ``mean(hidden^2) + coef * balance``, reduced
as the trainer reduces them, with the tensors autograd saved). A training
case may save each rank's first-step grads (``capture_grads``).
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

        def before(y, w, bias, mesh, active=None):
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
        mp.setattr(Trainer, "_whole_sums", lambda self, cuts, sums: whole(
            self, [c if any(a == "model" for a, _ in c) else c + (("model", 0),)
                   for c in cuts], sums))
    elif fault == "lora_unsummed_over_model":
        # each model rank's adapter grads (its block's share) left unsummed
        from polyaxon_tpu_torch.partition.lora import LoRATask

        mp.setattr(LoRATask, "partial_sum_axes", lambda self, mesh: {})
    elif fault == "af_block_shape":
        # adafactor factored by the shape of the rank's block
        from polyaxon_tpu_torch.train.optimizers import Adafactor

        leaf = Adafactor._leaf
        mp.setattr(Adafactor, "_leaf", lambda self, i, p: (tuple(p.shape), leaf(self, i, p)[1]))
    elif fault == "af_local_means":
        # each rank's factor means over its block alone (slices still gathered)
        from polyaxon_tpu_torch.train.optimizers import Adafactor

        mean = Adafactor._mean
        mp.setattr(Adafactor, "_mean", lambda self, t, dim, cuts: mean(
            self, t, dim, tuple(c for c in cuts if c[1] != dim)))
    elif fault == "af_block_rms":
        # the update clip and the param scale read the block's RMS
        from polyaxon_tpu_torch.train import optimizers

        mp.setattr(optimizers.Adafactor, "_rms", lambda self, t, cuts: optimizers._rms(t))
    elif fault == "reshard_adjoint":
        # the reshard's backward as the forward's plain adjoint: the read
        # block's grad zero-padded, not gathered over the read cut
        from polyaxon_tpu_torch.parallel import mesh as mesh_mod

        def adjoint(self, t, axis, stored, read):
            if stored is not None:
                t = self.gather(t, stored, axis)
            return t if read is None else self.block(t, read, axis)

        mp.setattr(mesh_mod.Mesh, "reshard", adjoint)
    elif fault == "resnet_grads_over_model":
        # the replicated compute's grads summed over the model ranks
        from polyaxon_tpu_torch.train.trainer import Trainer

        summed = Trainer._sum_grad
        mp.setattr(Trainer, "_sum_grad", lambda self, g, cuts, partial: (
            summed(self, g, cuts, partial), self.mesh.sum_(g, "model")))
    elif fault == "pp_microbatch_off_by_one":
        # each tick processes the next microbatch, not its own
        from polyaxon_tpu_torch.parallel import pipeline

        mp.setattr(pipeline, "_tick_microbatch", lambda t, stage: t - stage + 1)
    elif fault == "pp_sum_cotangents":
        # the last stage back-propagates the stages' cotangents summed
        from polyaxon_tpu_torch.parallel import collectives, pipeline

        mp.setattr(pipeline, "_output_cotangent", lambda g, mesh: collectives.sum_over(
            g.clone(), mesh.group("stage")))
    elif fault == "pp_embed_stage0_only":
        # the trunk input's cotangent stays on stage 0
        import torch

        from polyaxon_tpu_torch.parallel import pipeline

        mp.setattr(pipeline, "_share_input_cotangent",
                   lambda dx, like, mesh: dx if dx is not None else torch.zeros_like(like))
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


def _cuts(cfg, params, mesh) -> dict:
    """Each leaf's (axis, dim) cuts on this mesh, as the trainer cuts them."""
    from polyaxon_tpu_torch.models import transformer
    from polyaxon_tpu_torch.parallel import ShardingRules
    from polyaxon_tpu_torch.parallel.fsdp import leaf_dims

    rules = ShardingRules().override(layers="stage") if mesh.pp > 1 else ShardingRules()
    specs = transformer.param_specs(cfg, rules)
    on = {"stage": mesh.pp > 1, "expert": mesh.ep > 1, "model": mesh.tp}
    out: dict = {}
    for axis in ("stage", "expert", "model"):
        if on[axis]:
            for path, d in transformer.flatten(leaf_dims(specs, params, mesh.sizes[axis],
                                                         axis)):
                if d is not None:
                    out.setdefault(path, []).append((axis, d))
    return {p: tuple(out.get(p, ())) for p, _ in transformer.flatten(params)}


def _grads(case: dict, case_dir: str, rank: int) -> dict:
    """One forward and backward of ``case["params"]`` on this rank's rows
    and chunk of ``case["tokens"]`` over the case's mesh, with the model
    config's ``case["cfg"]`` changes: saves the hidden states, aux, the loss
    share and the grads of each leaf's block (summed over the token ranks as
    the trainer sums them), and counts what autograd saved."""
    import numpy as np
    import torch

    from polyaxon_tpu_torch.models import REGISTRY, transformer
    from polyaxon_tpu_torch.parallel import build_mesh
    from polyaxon_tpu_torch.parallel.fsdp import ShardedTree
    from polyaxon_tpu_torch.parallel.mesh import BATCH_AXES, TOKEN_AXES, grad_sum_axes

    cfg = replace(REGISTRY[case["spec"]["model"]][1], **case.get("cfg", {}))
    mesh = build_mesh(case["spec"]["parallelism"])
    params = torch.load(case["params"], weights_only=True)
    tokens = torch.from_numpy(np.load(case["tokens"]).astype(np.int64))
    cuts = _cuts(cfg, params, mesh)
    paths = [p for p, _ in transformer.flatten(params)]
    diff = [mesh.shard(t, cuts[p]).requires_grad_() for p, t in transformer.flatten(params)]
    tree = transformer.unflatten(paths, diff)
    if mesh.ep > 1 and cfg.moe_dispatch != "a2a":
        # capacity and dense read every expert: gathered, as the trainer does
        gathered = [tuple(c for c in cuts[p] if c[0] == "expert") for p in paths]
        tree = ShardedTree(tree, transformer.unflatten(paths, gathered), mesh.gather)
    B, S = tokens.shape
    nb, cp = mesh.axis_size(*BATCH_AXES), mesh.cp
    b, s = B // nb, S // cp
    r0, c0 = mesh.index(BATCH_AXES) * b, mesh.seq_index * s
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        hidden, aux = transformer.apply_hidden(tree, tokens[r0:r0 + b, c0:c0 + s], cfg,
                                               mesh=mesh, return_aux=True)
        shares = mesh.axis_size(*TOKEN_AXES)
        loss = (hidden.float() ** 2).sum() / (B * S * cfg.hidden) \
            + cfg.router_aux_coef * aux[0] / shares
    grads = torch.autograd.grad(loss, diff, allow_unused=True, materialize_grads=True)
    out = {}
    for p, g in zip(paths, grads):
        g = g.contiguous()
        mesh.sum_(g, *grad_sum_axes([a for a, _ in cuts[p]]))
        out["/".join(p)] = g
    torch.save({"hidden": hidden.detach(), "aux": aux.detach(), "grads": out,
                "cuts": {"/".join(p): [list(c) for c in cuts[p]] for p in paths}},
               os.path.join(case_dir, f"rank{rank}.pt"))
    total = torch.tensor([loss.item()], dtype=torch.float64)
    mesh.sum_(total, *TOKEN_AXES)
    return {"rows": [r0, r0 + b], "cols": [c0, c0 + s], "coords": mesh.coords(),
            "loss": float(total.item()), "saved_count": len(saved),
            "saved_bytes": int(sum(saved))}


class _Capture:
    """The first step's grads of a training run on this rank: the trainer's
    optimizer wrapped so its first update records the grads it is given."""

    def __init__(self, mp):
        from polyaxon_tpu_torch.train import trainer as trainer_mod

        self.trainer, self.grads = None, None
        make, init = trainer_mod.make_optimizer, trainer_mod.Trainer.__init__
        capture = self

        class Tx:
            def __init__(self, inner):
                self.inner = inner

            def init(self, leaves):
                return self.inner.init(leaves)

            def layout(self, *args):
                self.inner.layout(*args)

            def update(self, grads, *args, **kwargs):
                if capture.grads is None:
                    capture.grads = [g.detach().clone() for g in grads]
                return self.inner.update(grads, *args, **kwargs)

        def wrapped_init(self, *args, **kwargs):
            init(self, *args, **kwargs)
            capture.trainer = self

        mp.setattr(trainer_mod, "make_optimizer", lambda cfg: Tx(make(cfg)))
        mp.setattr(trainer_mod.Trainer, "__init__", wrapped_init)

    def save(self, path: str) -> None:
        import torch

        from polyaxon_tpu_torch.models.transformer import flatten

        t = self.trainer
        paths = ["/".join(p) for p, _ in flatten(t.specs)]
        torch.save({"grads": dict(zip(paths, self.grads)),
                    "cuts": {p: [list(c) for c in cuts] for p, cuts in zip(paths, t._cuts)},
                    "coords": t.mesh.coords()}, path)


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
            if case.get("model_cfg"):
                _configure(case["spec"]["model"], mp, **case["model_cfg"])
            if case.get("restore_shards"):
                artifacts = os.path.join(plan["out"], case.get("artifacts", case["name"]))
                result = _restore_shards(case["spec"], artifacts, case_dir, rank)
            elif case.get("forward"):
                result = _forward(case, case_dir, rank)
            elif case.get("grads"):
                result = _grads(case, case_dir, rank)
            elif case.get("expect_error"):
                try:
                    run_builtin(case["spec"])
                    result = {"error": None}
                except SystemExit as e:
                    result = {"error": str(e)}
            else:
                capture = _Capture(mp) if case.get("capture_grads") else None
                logged = []
                for spec in case["runs"] if "runs" in case else [case["spec"]]:
                    summary = run_builtin(spec, track=lambda i, m: logged.append(
                        {"step": i, "loss": m["loss"], "grad_norm": m["grad_norm"],
                         **{k: m[k] for k in ("router_aux", "router_drop_frac") if k in m}}))
                result = {"logged": logged, "summary": summary}
                if capture is not None:
                    capture.save(os.path.join(case_dir, f"grads{rank}.pt"))
        finally:
            mp.undo()
        with open(os.path.join(case_dir, f"rank{rank}.json"), "w") as f:
            json.dump(result, f)
        print(f"[worker {rank}] done {case['name']}", flush=True)
    parallel.shutdown()


if __name__ == "__main__":
    main()
