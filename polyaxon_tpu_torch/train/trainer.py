"""The training loop of the port — counterpart of
``polyaxon_tpu/train/trainer.py``, on one device or over a mesh of
processes (one per GPU) with the ``data``, ``fsdp``, ``model``,
``context``, ``stage`` and ``expert`` axes.

One step = the microbatch loop (grads in ``grad_dtype``, summed in
``accum_dtype`` and divided by k; the task's metrics averaged over the
microbatches), the global norm of the unclipped grads, the divergence
guard (a non-finite loss or grad norm keeps the old params, optimizer
state and extra, and freezes the schedule and the optimizer's count),
then the optimizer. ``fit`` runs the JAX package's policy around it: the
throughput meter, periodic and final checkpoint saves, the skip budget,
the rollback to the newest complete checkpoint
(``anomaly_rollback_budget``) and ``TrainingDivergedError``, the step
watchdog.

Where the JAX step selects old or new values inside jit, this one reads
the guard's verdict on the host once per step (before the update) and
then updates params and moments in place: no second copy of the state is
ever live. Since the host waits for that verdict anyway, ``fit`` applies
the skip policy to each step's flags as soon as the step returns (the JAX
package reads them one step late so as not to wait), and a save at a
step boundary covers only resolved-clean steps.

Over a mesh (a ``torch.distributed`` group) every number the step returns
is the one the JAX package's SPMD step returns on a mesh of that shape:

- each rank trains on its rows of the global batch (``data.local_rows``)
  and, under ``context``, its chunk of the sequence (``data.local_cols``);
  the task's loss and metrics are its share of the batch's, and the
  metrics are summed over the batch and context ranks; batch norms and
  MLM counts are the whole batch's;
- ``data`` and ``context``: params are replicated, and the grads are
  summed over the ranks after the microbatch loop;
- ``model``: each rank holds its block of every ``model``-sharded leaf
  (heads, mlp columns, vocab rows) of the params, the optimizer state and
  the grads, and runs the model's tensor-parallel layers on it; a sharded
  leaf keeps its own block's grad, a replicated one (norms, the biases
  added after a row-parallel sum) gets the same grad on every model rank;
- ``fsdp`` (declared, at any size): each rank holds its block of every
  ``embed``-sharded leaf (the task's PartitionSpecs) of the f32 master
  params, of the optimizer's param-shaped state and of the grads. The
  model gathers a leaf where it uses it, each layer's just before the
  layer runs (in ``grad_dtype``), and each gather's backward
  reduce-scatters the grad to the shard; with ``data`` too, shards are
  then summed over the data ranks. adafactor's factored moments are the
  whole factors on every rank, as the JAX trainer replicates them, and
  its update reads the whole leaf (``train/optimizers.py``);
- ``stage``: each rank holds its block of the stacked layers (the JAX
  trainer's ``layers -> stage`` rule) and runs them as a pipeline stage;
  every leaf outside the trunk (embedding, final norm, head, learned
  positions) is computed alike on every stage rank and gets the same grad
  there, the stage-free run's; a task without a layered trunk raises;
- ``expert`` (a batch axis): each rank holds its block of the experts;
  capacity and dense dispatch gather them where the layer runs (the
  backward sums the grad over the expert ranks), all-to-all uses the
  rank's own; an expert leaf's grad is then summed over the other token
  axes only;
- the grads' global norm sums each leaf's squares over its shards (fsdp,
  model, stage, expert), so each logical element counts once, and the
  guard's verdict reads the summed metrics, so every rank skips the same
  steps;
- no rank ever holds a leaf whole unless its block is the leaf: a fresh
  init builds each rank's blocks alone from the task's init laws
  (``parallel/blocks.py``), an import or a fork reads them alone, and a
  checkpoint is each rank's blocks, written by the first rank that holds
  each and read back by overlap at any world size and mesh
  (``train/checkpoint.py``); rank 0 names the step the others restore.

The JAX Trainer's ``partition_rules`` lay a user's rules over the task's
specs before the cuts are derived. The rule's spec is the leaf's storage:
its params, grads and param-shaped optimizer state are cut as it says. The
layer bodies read each leaf as the built-in spec cuts it over the compute
axes (``model``, ``stage``, and ``expert`` under all-to-all): where the
two differ, the read reshards the leaf (``parallel/fsdp.py``), as GSPMD
reshards it where it is read. Its ``tx`` replaces the config's optimizer:
a LoRA run's frozen base (``partition/lora.py``) trains the adapters alone. The step
still takes every floating leaf's grad, and ``grad_norm`` and the guard
cover them all, as ``optax.global_norm(grads)`` does; the optimizer's clip
reads the norm of the leaves it trains, and the others get no update.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, Optional

import torch

from ..models.transformer import TransformerConfig, flatten, unflatten
from ..obs.spans import span
from ..parallel.blocks import Placement, init_tree
from ..parallel.fsdp import ShardedTree, fresh, leaf_dims
from ..parallel.mesh import (
    BATCH_AXES, TOKEN_AXES, Mesh, ShardingRules, build_mesh, grad_sum_axes,
    normalize_axis_sizes,
)
from ..parallel.pipeline import validate_pipeline_mesh
from .checkpoint import CheckpointConfig, Checkpointer
from .metrics import ThroughputMeter
from .optimizers import (
    OptimizerConfig, global_norm, make_optimizer, opt_state_from_tree, opt_state_tree,
    state_cuts,
)
from .tasks import LMTask, Task, ViTTask, refuse_unsupported_axes

#: the axes a param leaf may be cut over, in the order its blocks are taken
CUT_AXES = ("stage", "expert", "fsdp", "model")


@dataclass
class TrainState:
    params: dict          # f32 master params, updated in place
    opt_state: Any        # the optimizer's state (train/optimizers.py)
    step: int             # attempted steps (== batches consumed)
    extra: Any = None


@dataclass(frozen=True)
class TrainerConfig:
    model: Any
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    batch_size: int = 8
    seq_len: int = 128
    # mesh axes over the process group; None: data absorbs every process
    parallelism: Optional[dict] = None
    num_slices: int = 1
    checkpoint: Optional[CheckpointConfig] = None
    log_interval: int = 10
    accelerator: Optional[str] = "h100"  # the meter's peak table; None: no MFU
    # differentiate w.r.t. params cast to this dtype (grads land in it)
    grad_dtype: Optional[str] = None
    # split the batch into this many sequential microbatches, grads summed
    microbatches: int = 1
    accum_dtype: Optional[str] = None    # None = float32
    anomaly_skip_budget: int = 3
    # rollbacks to the newest complete checkpoint allowed before fit()
    # fails loudly with the anomaly history
    anomaly_rollback_budget: int = 2
    watchdog: bool = False
    watchdog_stall_factor: float = 10.0
    watchdog_min_s: float = 120.0
    watchdog_compile_grace_s: float = 1800.0


class TrainingDivergedError(RuntimeError):
    """The run burned its anomaly budgets: ``anomaly_skip_budget``
    consecutive non-finite steps with no rollback left (or no complete
    checkpoint to roll back to). Carries the anomaly history."""

    def __init__(self, message: str, history: list, anomalies: dict, rollbacks: int):
        super().__init__(message)
        self.history = history
        self.anomalies = anomalies
        self.rollbacks = rollbacks


class Trainer:
    """The JAX package's Trainer: the Task supplies init, specs and loss;
    ``device`` is this process's device, where its params, state and
    batches live; ``mesh`` defaults to ``build_mesh(cfg.parallelism)`` over
    the process group (one process without one)."""

    def __init__(
        self,
        cfg: TrainerConfig,
        *,
        device: Any,
        mesh: Optional[Mesh] = None,
        track: Optional[Callable[[int, dict], None]] = None,
        task: Optional[Task] = None,
        chaos: Optional[Any] = None,
        on_span: Optional[Callable[..., None]] = None,
        on_progress: Optional[Callable[[int, dict, int], None]] = None,
        on_stalled: Optional[Callable[[int, float, float], None]] = None,
        log_line: Optional[Callable[[str], None]] = None,
        partition_rules: Optional[Any] = None,
        tx: Optional[Any] = None,
    ):
        refuse_unsupported_axes(cfg.model, normalize_axis_sizes(cfg.parallelism))
        self.cfg = cfg
        if task is None:
            if not isinstance(cfg.model, TransformerConfig):
                raise ValueError(
                    f"model config {type(cfg.model).__name__} needs an explicit Task")
            task = LMTask(cfg.model)
        self.task = task
        self.device = torch.device(device)
        self.mesh = mesh if mesh is not None else build_mesh(
            cfg.parallelism, num_slices=cfg.num_slices)
        refuse_unsupported_axes(cfg.model, self.mesh.sizes)
        rules = ShardingRules()
        if self.mesh.pp > 1:
            validate_pipeline_mesh(self.mesh)
            if not isinstance(task, (LMTask, ViTTask)):
                raise NotImplementedError(
                    f"pipeline parallelism needs a layered transformer trunk; "
                    f"{type(task).__name__} has none")
            # layers shard over stages: each stage owns L/S layers
            rules = rules.override(layers="stage")
        # the axes that cut param leaves, and those the model gathers a leaf
        # over where it reads it (the experts stay cut under all-to-all)
        self._cut_axes = self._live_axes()
        model_cfg = getattr(getattr(task, "inner", task), "cfg", None)
        a2a = getattr(model_cfg, "moe_dispatch", None) == "a2a"
        self._gathered_axes = tuple(a for a in ("expert", "fsdp")
                                    if a in self._cut_axes and not (a == "expert" and a2a))
        # the axes whose cut of a leaf the layer bodies read as a block
        self._compute_axes = tuple(a for a in self._cut_axes if a not in self._gathered_axes)
        self.primary = self.mesh.rank == 0
        # this rank's place over the batch axes, and how many share the batch
        self.batch_ranks = self.mesh.axis_size(*BATCH_AXES)
        self.batch_index = self.mesh.index(BATCH_AXES)
        # the axes a token's loss term is spread over: the batch's, and the
        # sequence's where the task cuts it (a task that replicates its
        # compute over ``context`` keeps the batch's alone)
        self.token_axes = getattr(task, "token_axes", TOKEN_AXES)
        # the built-in specs cut what the layer bodies read; a user's rules
        # lay the storage over them
        self.compute_specs = task.param_specs(rules)
        self.specs = self.compute_specs
        if partition_rules:
            self.specs = self._overlay(partition_rules)
        # each param leaf's (axis, dim) cuts (flatten order), and the view's
        # trees: the cuts the model gathers and the compute axes' reshards
        # (None: the model reads every leaf as it is)
        self._cuts: list = []
        self._paths: Optional[tuple] = None
        self._view: Optional[tuple] = None
        # the optimizer: the config's, or a given one (a LoRA run's frozen
        # base); ``trains(path)`` names the leaves it updates and keeps state
        # for (every leaf by default)
        self.tx = tx if tx is not None else make_optimizer(cfg.optimizer)
        self._opt_index: list = []
        self.track = track
        # duck-typed fault injection: pre_step(pos) and nan_due(pos)
        self.chaos = chaos
        # the tracking bridge, as in the JAX trainer: on_span(name, start,
        # end, **meta) for the first step, the train window, saves,
        # rollbacks and a stall; on_progress(step, anomaly counts,
        # rollbacks) after every step; on_stalled(step, waited, limit)
        # before the watchdog's hard exit; log_line for the loop's lines.
        # They are given host values only: no hook syncs the device.
        self.on_span = on_span
        self.on_progress = on_progress
        self.on_stalled = on_stalled
        self.log_line = log_line
        # rank 0 owns the directory; every rank writes its own blocks of a
        # step, and restores the steps rank 0 names
        self.checkpointer = (Checkpointer(cfg.checkpoint, rank=self.mesh.rank,
                                          world=self.mesh.size if self.mesh.distributed else 1)
                             if cfg.checkpoint else None)

    def _overlay(self, partition_rules: Any) -> dict:
        """The task's specs with the user's ``partition_rules`` laid over
        them, as the JAX trainer lays them: the storage of each leaf. It
        raises what the JAX package raises: an unknown axis here, a cut
        that does not divide where the leaves are cut."""
        from ..partition.rules import overlay_partition_rules, parse_rules

        return overlay_partition_rules(parse_rules(partition_rules),
                                       self.task.abstract_params(), self.specs)

    def _live_axes(self) -> tuple:
        mesh = self.mesh
        on = {"stage": mesh.pp > 1, "expert": mesh.ep > 1, "fsdp": mesh.sharded,
              "model": mesh.tp}
        return tuple(a for a in CUT_AXES if on[a])

    # -- init ---------------------------------------------------------------

    def _layout(self, params: dict) -> None:
        """Resolve each param leaf's cuts, the view the model reads through,
        the optimizer's leaves and the partial-sum axes from a tree with
        the params' shapes (``meta`` tensors will do)."""
        paths, leaves = zip(*flatten(params))
        mesh = self.mesh

        def cut_dims(specs, axes):
            return {a: [d for _, d in flatten(leaf_dims(specs, params, mesh.sizes[a], a))]
                    for a in axes}

        dims = cut_dims(self.specs, self._cut_axes)
        self._cuts = [tuple((a, dims[a][n]) for a in self._cut_axes if dims[a][n] is not None)
                      for n in range(len(leaves))]
        gathered = [tuple(c for c in cuts if c[0] in self._gathered_axes)
                    for cuts in self._cuts]
        # where the storage's cut on a compute axis is not the built-in
        # one: (axis, stored dim, read dim), the read's reshard
        read = cut_dims(self.compute_specs, self._compute_axes)
        moves = [tuple((a, dims[a][n], read[a][n]) for a in self._compute_axes
                       if dims[a][n] != read[a][n]) for n in range(len(leaves))]
        self._view = ((unflatten(paths, gathered),
                       unflatten(paths, moves) if any(moves) else None)
                      if any(gathered) or any(moves) else None)
        self._paths = paths
        self._shapes = [tuple(t.shape) for t in leaves]
        trains = getattr(self.tx, "trains", None)
        self._opt_index = [i for i, p in enumerate(paths)
                           if trains is None or trains("/".join(p))]
        # a grad whose leaf's block this rank computes a part of (a LoRA
        # adapter of a model-cut leaf) is summed over those axes too
        partial = getattr(self.task, "partial_sum_axes", None)
        partial = partial(mesh if mesh.distributed else None) if partial else {}
        self._partial_axes = [partial.get("/".join(p), ()) for p in paths]

    def placement(self) -> Placement:
        """Where this rank's blocks of the params lie: each leaf's cuts (by
        its ``/``-joined path), the mesh's sizes and this rank's
        coordinates."""
        if self._paths is None:
            self._layout(self.task.abstract_params())
        return Placement(cuts={"/".join(p): c for p, c in zip(self._paths, self._cuts) if c},
                         sizes=dict(self.mesh.sizes), coords=self.mesh.coords())

    def init_params(self, seed: int = 0) -> dict:
        """This rank's blocks of a fresh init of the params: each leaf's
        block built alone from the task's init laws
        (``parallel/blocks.py``), never the whole leaf unless the block is
        it; the values are the same blocks of the whole-tree init."""
        return init_tree(self.task.param_laws(), seed, self.device, self.placement())

    def init_state(self, seed: int = 0) -> TrainState:
        """A fresh state: this rank's blocks of the params, the extra state
        (replicated) and the optimizer state on the blocks."""
        params = self.init_params(seed)
        return self._state_around(params, init_tree(self.task.extra_laws(), seed,
                                                     self.device))

    def init_state_from(self, params: dict, extra: Any = None) -> TrainState:
        """A state around full ``params`` (every rank's alike; the JAX
        parity tests and serving hold such trees): under the cutting axes
        each rank keeps its block of each leaf, and the optimizer state
        mirrors the blocks."""
        self._layout(params)
        if any(self._cuts):
            paths, leaves = zip(*flatten(params))
            params = unflatten(paths, [self.mesh.shard(t, c)
                                       for t, c in zip(leaves, self._cuts)])
        return self._state_around(params, extra)

    def init_state_from_blocks(self, params: dict, extra: Any = None) -> TrainState:
        """A state around this rank's blocks of the params (an import or a
        fork read by block): each must have its block's shape."""
        place = self.placement()
        for path, t in flatten(params):
            name = "/".join(path)
            want = place.bounds(name, self._shapes[self._paths.index(path)])[1]
            if list(t.shape) != list(want):
                raise ValueError(f"the block of {name} has shape {tuple(t.shape)}, this "
                                 f"rank's is {tuple(want)}")
        return self._state_around(params, extra)

    def _state_around(self, params: dict, extra: Any) -> TrainState:
        leaves = [t for _, t in flatten(params)]
        opt_leaves = [leaves[i] for i in self._opt_index]
        self.tx.layout([self._shapes[i] for i in self._opt_index], self._opt_cuts(), self.mesh)
        return TrainState(params=params, opt_state=self.tx.init(opt_leaves), step=0,
                          extra=extra)

    def _agreed(self, value: Optional[int]) -> Optional[int]:
        """Rank 0's ``value`` on every rank (a decision about the shared
        checkpoint directory, which only rank 0 reads as the writer)."""
        return self.mesh.agree(value if self.primary else None, self.device)

    def restore_or_init(self, seed: int = 0, init_params: Optional[dict] = None,
                        init_extra: Any = None) -> tuple[TrainState, int]:
        """Latest complete checkpoint wins (resume); else ``init_params``
        (this rank's blocks of the params: a checkpoint import, a fork) and
        ``init_extra`` when given; else a fresh init. A directory of the
        JAX package's Orbax steps raises
        :class:`~.checkpoint.ForeignCheckpointError` instead of starting
        over."""
        if init_params is not None:
            state = self.init_state_from_blocks(init_params, init_extra)
        else:
            state = self.init_state(seed)
        if self.checkpointer and self._agreed(
                self.checkpointer.latest_step() if self.primary else None) is not None:
            try:
                # skips torn steps via the checksum manifests and restores
                # the newest COMPLETE one
                return self.restore(state)
            except FileNotFoundError:
                # every candidate failed verification: a fresh start beats
                # training from (or crashing on) a torn checkpoint
                print("[trainer] no complete checkpoint survived "
                      "verification; starting from step 0", flush=True)
        return state, 0

    def latest_complete_step(self) -> Optional[int]:
        """The newest complete step of the run's checkpoints, as rank 0
        (the writer, which heals the directory first) sees it."""
        return self._agreed(self.checkpointer.latest_complete_step() if self.primary
                            else None)

    def restore(self, state: TrainState, step: Optional[int] = None) -> tuple[TrainState, int]:
        """Restore the newest complete checkpoint (or ``step``) into
        ``state``'s tensors in place; returns the restored state and its
        step. Over a mesh every rank restores the step rank 0 names, each
        reading its blocks from the parts of the saved blocks they overlap
        (the step may have been saved at any world size and mesh)."""
        like = state_tree(state)
        if self.mesh.distributed:
            chosen = step
            if self.primary and chosen is None:
                chosen = self.checkpointer.latest_complete_step()
                if chosen is None:
                    # the single-process walk: purge what failed, then raise
                    try:
                        self.checkpointer.restore(like)
                    except FileNotFoundError:
                        pass
            step = self._agreed(chosen)
            if step is None:
                raise FileNotFoundError(
                    f"No complete checkpoint under {self.checkpointer.cfg.directory}")
        tree, s = self.checkpointer.restore(like, step=step,
                                            placement=self.state_placement(state))
        return state_from_tree(tree), s

    def state_placement(self, state: TrainState) -> Placement:
        """Where this rank's blocks of ``state``'s checkpoint tree lie: the
        params' cuts under ``params/``, each param-shaped optimizer leaf's
        under ``opt_state/<field>/<i>`` (the factors and extra are
        whole)."""
        place = self.placement().prefixed("params")
        cuts = dict(place.cuts)
        for name, leaf_cuts in state_cuts(state.opt_state, self._opt_cuts()).items():
            cuts.update({f"opt_state/{name}/{i}": c for i, c in enumerate(leaf_cuts) if c})
        return Placement(cuts=cuts, sizes=place.sizes, coords=place.coords)

    def _opt_cuts(self) -> list:
        """The cuts of the leaves the optimizer keeps state for, in its
        state's order."""
        return [self._cuts[i] for i in self._opt_index]

    def _save(self, step: int, state: TrainState) -> bool:
        """Every rank hands the checkpointer its blocks of the state (each
        block is written by the first rank that holds it; no rank gathers a
        leaf); returns whether the save started."""
        return self.checkpointer.maybe_save(step, state_tree(state), force=True,
                                            placement=self.state_placement(state))

    # -- the step -------------------------------------------------------------

    def _loss(self, params, extra, batch, inject: bool):
        kwargs = {"mesh": self.mesh} if self.mesh.distributed else {}
        loss, metrics, new_extra = self.task.loss(params, extra, batch, **kwargs)
        if inject:
            # poisons the loss and every gradient from it, as a real
            # divergence would
            loss = loss * float("nan")
        return loss, {**metrics, "loss": loss}, new_extra

    def make_step(self):
        gd = getattr(torch, self.cfg.grad_dtype) if self.cfg.grad_dtype else None
        ad = getattr(torch, self.cfg.accum_dtype) if self.cfg.accum_dtype else torch.float32
        k = max(int(self.cfg.microbatches), 1)
        if self.cfg.batch_size % k:
            raise ValueError(f"batch_size {self.cfg.batch_size} not divisible by "
                             f"microbatches {k}")
        mesh = self.mesh
        if (self.cfg.batch_size // k) % self.batch_ranks:
            raise ValueError(f"a microbatch of {self.cfg.batch_size // k} rows does not "
                             f"split over {self.batch_ranks} ranks")
        # this rank's rows of each microbatch: its batch is data.local_rows'
        size = self.cfg.batch_size // k // self.batch_ranks

        def step_fn(state: TrainState, batch: dict, inject: bool = False):
            paths, leaves = zip(*flatten(state.params))
            diff = [(p.detach().to(gd) if gd is not None and p.is_floating_point()
                     else p.detach()).requires_grad_(p.is_floating_point())
                    for p in leaves]
            diff_tree = unflatten(paths, diff)
            if self._view is not None:
                gather, moves = self._view
                diff_tree = ShardedTree(diff_tree, gather, mesh.gather, reshard=(
                    None if moves is None else (moves, mesh.reshard)))
            floating = [i for i, p in enumerate(leaves) if p.is_floating_point()]
            cuts = [self._cuts[i] for i in floating]
            partial = [self._partial_axes[i] for i in floating]
            batch = {name: t.to(self.device) for name, t in batch.items()}
            grads, per_micro, extra = None, [], state.extra
            for i in range(k):
                with span("train.microbatch"):
                    mb = {name: t[i * size:(i + 1) * size] for name, t in batch.items()}
                    # each microbatch gathers the params anew
                    with span("train.forward"):
                        loss, m, extra = self._loss(fresh(diff_tree), extra, mb, inject)
                    with span("train.backward"):
                        g = torch.autograd.grad(loss, [t for t in diff if t.requires_grad],
                                                allow_unused=True, materialize_grads=True)
                    per_micro.append({name: v.detach() for name, v in m.items()})
                    if k == 1:
                        grads = list(g)
                    elif grads is None:
                        grads = [gi.to(ad) for gi in g]
                    else:
                        for acc, gi in zip(grads, g):
                            acc.add_(gi.to(ad))
                    del g, loss, m
            if k > 1:
                grads = [g / k for g in grads]
            # the task's metrics, each the mean over the microbatches (as the
            # JAX step's scan averages them); tensors, so no device sync
            task_metrics = (per_micro[0] if k == 1 else
                            {name: torch.stack([m[name] for m in per_micro]).mean()
                             for name in per_micro[0]})
            whole = None
            if mesh.distributed:
                with span("train.grad_sync"):
                    task_metrics = self._sum_metrics(task_metrics)
                    for i, c in enumerate(cuts):
                        # NCCL reduces dense tensors only (autograd may hand
                        # back a strided view)
                        grads[i] = grads[i].contiguous()
                        self._sum_grad(grads[i], c, partial[i])
                if any(cuts):
                    whole = self._whole_sums
            loss = task_metrics["loss"]
            # the optimizer's leaves, as positions among the grads
            trained = [floating.index(i) for i in self._opt_index]
            with span("train.optimizer"):
                grad_norm, clip_norm = self._norms(grads, cuts, trained, whole)
                loss_ok = torch.isfinite(loss)
                grad_ok = torch.isfinite(grad_norm)
                metrics = {
                    **task_metrics, "grad_norm": grad_norm,
                    "anomaly_loss": (~loss_ok).float(),
                    "anomaly_grad": (loss_ok & ~grad_ok).float(),
                }
                opt_state = state.opt_state
                with span("train.sync"):
                    finite = bool(loss_ok & grad_ok)
                if finite:
                    masters = [leaves[floating[i]] for i in trained]
                    updates, opt_state = self.tx.update([grads[i] for i in trained],
                                                        opt_state, masters, clip_norm)
                    with torch.no_grad():
                        # a leaf the optimizer does not train gets no update,
                        # not even a zero (which would turn a -0.0 into +0.0)
                        for p, u in zip(masters, updates):
                            p.add_(u.to(p.dtype))
                    state.extra = extra
            # a skipped step keeps the old params, moments, schedule and
            # count; ``step`` counts attempted steps (== batches consumed)
            return TrainState(state.params, opt_state, state.step + 1, state.extra), metrics

        return step_fn

    def _sum_grad(self, g: torch.Tensor, cuts: tuple, partial: tuple) -> None:
        """A leaf's grad summed in place over the token ranks that hold the
        same block, less the axes a gathered shard (fsdp, experts) was
        summed over already by its gather's reduce-scatter or the experts'
        all-to-all, then over ``partial``: the axes whose ranks each
        compute a part of it (a LoRA adapter's block deltas)."""
        self.mesh.sum_(g, *grad_sum_axes([a for a, _ in cuts], self.token_axes))
        if partial:
            self.mesh.sum_(g, *partial)

    def _norms(self, grads: list, cuts: list, trained: list,
               whole: Optional[Callable]) -> tuple:
        """(the reported grad norm, the norm the optimizer's clip reads):
        the global norm of every grad (base and adapters, as the JAX
        trainer's ``optax.global_norm(grads)``), and that of the grads the
        optimizer trains (``trained``: their positions), which is the same
        norm unless it trains a part of the leaves. Both stay on the device.
        ``whole``: :meth:`_whole_sums` over a mesh that cuts leaves."""
        def over(c):
            return functools.partial(whole, c) if whole is not None and any(c) else None

        norm = global_norm(grads, over(cuts))
        if len(trained) == len(grads):
            return norm, norm
        sub = [cuts[i] for i in trained]
        return norm, global_norm([grads[i] for i in trained], over(sub))

    def _sum_metrics(self, metrics: dict) -> dict:
        """The token ranks' shares of each metric, summed: the batch's
        values (every model rank holds the same)."""
        names = sorted(metrics)
        vec = torch.stack([metrics[n].detach().float() for n in names])
        self.mesh.sum_(vec, *self.token_axes)
        return {n: vec[i] for i, n in enumerate(names)}

    def _whole_sums(self, cuts: list, sums: list) -> list:
        """Each leaf's sum of squares over the whole leaf: a block's summed
        over the ranks of each axis that cuts it (fsdp, model, stage,
        expert). A leaf replicated over an axis is whole there already, and
        counts once."""
        out = list(sums)
        for axis in CUT_AXES:
            idx = [i for i, c in enumerate(cuts) if any(a == axis for a, _ in c)]
            if not idx:
                continue
            vec = self.mesh.sum_(torch.stack([out[i] for i in idx]), axis)
            for j, i in enumerate(idx):
                out[i] = vec[j]
        return out

    # -- the loop -------------------------------------------------------------

    def _sync(self, metrics: dict) -> None:
        with span("train.sync"):
            float(metrics["loss"])
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def fit(self, batches: Iterator[dict], num_steps: int,
            state: Optional[TrainState] = None,
            meter: Optional[ThroughputMeter] = None) -> tuple[TrainState, dict]:
        if state is None:
            state, start = self.restore_or_init()
        else:
            start = int(state.step)
        step_fn = self.make_step()
        if meter is None:
            meter = ThroughputMeter(
                tokens_per_step=self.task.tokens_per_step(self.cfg.batch_size,
                                                          self.cfg.seq_len),
                flops_per_token=self.task.flops_per_token(self.cfg.seq_len),
                num_chips=self.mesh.size, accelerator=self.cfg.accelerator)
        metrics: dict = {}
        t_fit = time.time()  # span clock: epoch, as the control plane's
        t_train: Optional[float] = None
        log = self.log_line or (lambda line: print(line, flush=True))

        watchdog = None
        if self.cfg.watchdog:
            from .watchdog import StepWatchdog

            def _stall(step: int, waited: float, limit: float) -> None:
                now = time.time()
                if self.on_span:
                    # the span covers the silent window itself
                    self.on_span("training_stalled", now - waited, now,
                                 step=step, limit_s=round(limit, 3))
                if self.on_stalled:
                    self.on_stalled(step, waited, limit)

            watchdog = StepWatchdog(
                stall_factor=self.cfg.watchdog_stall_factor,
                min_s=self.cfg.watchdog_min_s,
                compile_grace_s=self.cfg.watchdog_compile_grace_s,
                p95_s=lambda: meter._interval_quantile(0.95),
                on_stall=_stall, log=log)
            watchdog.start()

        skip_budget = max(int(self.cfg.anomaly_skip_budget), 1)
        anomalies = {"loss": 0, "grad": 0}
        history: list[dict] = []
        consec = 0
        rollbacks = 0
        # absolute batch index the stream yields next; == the loop index
        # while the stream is seekable and rollbacks rewind it
        data_pos = int(getattr(batches, "position", start))

        def _diverged(msg: str) -> TrainingDivergedError:
            return TrainingDivergedError(
                f"{msg} (anomalies={anomalies}, rollbacks={rollbacks}, "
                f"skip_budget={skip_budget})",
                history[-64:], dict(anomalies), rollbacks)

        def _resolve(at: int, m: dict) -> Optional[int]:
            """Read a step's anomaly flags and apply the policy. Returns
            the step to rewind the loop to when a rollback happened, else
            None; raises TrainingDivergedError when the budgets are gone."""
            nonlocal consec
            with span("train.sync"):
                a_loss = bool(float(m["anomaly_loss"]))
                a_grad = bool(float(m["anomaly_grad"]))
            if not (a_loss or a_grad):
                consec = 0
                return None
            kind = "loss" if a_loss else "grad"
            anomalies[kind] += 1
            if len(history) < 256:
                history.append({"step": at, "kind": kind})
            consec += 1
            log(f"[trainer] non-finite {kind} at step {at}: update skipped "
                f"({consec}/{skip_budget} consecutive)")
            if consec < skip_budget:
                return None
            if (self.checkpointer is None
                    or rollbacks >= self.cfg.anomaly_rollback_budget):
                raise _diverged(f"{consec} consecutive non-finite steps at step "
                                f"{at} and no rollback budget left")
            return _rollback(at)

        def _rollback(at_step: int) -> int:
            """Roll back to the newest COMPLETE checkpoint: restore it
            (purging newer, possibly poisoned steps, so the replay's saves
            at those step numbers go through), rewind the data stream to
            it, and return it as the new loop index. The replayed window
            trains on the batches the uninterrupted run saw."""
            nonlocal state, consec, rollbacks, data_pos
            t0 = time.time()
            if watchdog is not None:
                watchdog.beat(at_step)  # the restore itself may be slow
            self.checkpointer.wait()  # settle an in-flight save
            try:
                state, s = self.restore(state)
            except FileNotFoundError as e:
                raise _diverged(f"anomaly streak at step {at_step} but no complete "
                                f"checkpoint survived verification") from e
            rollbacks += 1
            consec = 0
            seek = getattr(batches, "seek", None)
            if callable(seek):
                seek(s)
                data_pos = s
            else:
                log("[trainer] data stream is not seekable: resuming forward "
                    "from the current position, without exact parity")
            log(f"[trainer] rolled back to checkpoint step {s} after anomaly "
                f"streak at step {at_step} (rollback {rollbacks}/"
                f"{self.cfg.anomaly_rollback_budget})")
            if self.on_span:
                self.on_span("rollback", t0, time.time(), step=s,
                             from_step=at_step, rollbacks=rollbacks)
            meter.start()  # the restore pause is not a step interval
            if watchdog is not None:
                watchdog.beat(s)
            return s

        try:
            i = start
            while i < num_steps:
                if self.chaos is not None:
                    self.chaos.pre_step(data_pos)
                inject = self.chaos is not None and self.chaos.nan_due(data_pos)
                with span("train.data"):
                    batch = next(batches)
                data_pos += 1
                with span("train.step"):
                    state, metrics = step_fn(state, batch, inject)
                if watchdog is not None:
                    watchdog.beat(i)
                if self.on_progress is not None:
                    self.on_progress(i, anomalies, rollbacks)
                if t_train is None:
                    self._sync(metrics)  # the first step builds and warms up
                    t_train = time.time()
                    if self.on_span:
                        self.on_span("first-step-compiled", t_fit, t_train, step=i)
                    meter.start()
                else:
                    if i == num_steps - 1:
                        self._sync(metrics)  # close the last interval
                    meter.step()
                rewind = _resolve(i, metrics)
                if rewind is not None:
                    i = rewind
                    continue
                if self.track and (i % self.cfg.log_interval == 0 or i == num_steps - 1):
                    logged = {name: float(v) for name, v in metrics.items()}
                    logged.update(meter.summary())
                    self.track(i, logged)
                # the label covers resolved-clean steps only: a step inside
                # an anomaly streak is never published
                if self.checkpointer and consec == 0 and self._agreed(
                        self.primary and self.checkpointer.should_save(i + 1)):
                    t_save = time.time()
                    self._save(i + 1, state)
                    if self.on_span:
                        # async: the span covers the copy to the host and
                        # the hand-off to the writer thread
                        self.on_span("checkpoint-save", t_save, time.time(), step=i + 1)
                    if watchdog is not None:
                        watchdog.beat(i)  # a long save is progress, not a stall
                i += 1
        finally:
            if watchdog is not None:
                watchdog.stop()
        if t_train is not None and self.on_span:
            self.on_span("train", t_train, time.time(), steps=num_steps - start)
        if self.checkpointer:
            if self._agreed(self.primary and self.checkpointer.latest_step() != num_steps):
                t_save = time.time()
                if self._save(num_steps, state) and self.on_span:
                    self.on_span("checkpoint-save", t_save, time.time(), step=num_steps)
            self.checkpointer.wait()
            self.mesh.barrier()  # the step is on disk before any rank reads it
        final = {name: float(v) for name, v in metrics.items()}
        final.update(meter.summary())
        final["train_anomalies_loss"] = anomalies["loss"]
        final["train_anomalies_grad"] = anomalies["grad"]
        final["train_rollbacks"] = rollbacks
        return state, final


def state_tree(state: TrainState) -> dict:
    """A TrainState as the checkpoint's tree: params, the optimizer state's
    fields (count and per-param tensors), step and extra (the tensors are
    the state's own)."""
    return {"params": state.params, "opt_state": opt_state_tree(state.opt_state),
            "step": int(state.step), "extra": state.extra}


def state_from_tree(tree: dict) -> TrainState:
    return TrainState(params=tree["params"], opt_state=opt_state_from_tree(tree["opt_state"]),
                      step=int(tree["step"]), extra=tree.get("extra"))
