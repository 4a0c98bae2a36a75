"""One run of one cell: set-up, the timed window, the traced steps, the
reference and the comparison.

Set-up builds the port's trainer as its builtin runtime does
(``runtime/builtin.py``'s ``build_trainer`` over the example's runtime keys
and the keys the cell changes), checks it against the configuration file
and the family's layout (``layouts/<family>.py``), hands it weights the
benchmark made from the seed in that layout (``weights.py``), and makes the
cell's pool of batches on the host (``traffic/<objective>.py``). It then
drives the first steps through ``Trainer.fit`` and the same feed the window
uses, one step a call, and keeps
the program's readings of them (each loss, Adam's first moment after step 1,
each weight's change after the last). Those steps also warm every shape the
window runs.

The window hands that same trainer and state to ``Trainer.fit`` until
``--seconds`` have passed, in calls of as many steps as the time left holds
(the trainer waits for each step's result, so a call ends on a finished
step). The rate is the tokens of every step of the window over its whole
time. A traced run then profiles a few more steps.

Once the window has closed and the device's peak is read, the program's
state is freed, and the family's plain reference trains from the same
weights on the same first batches; ``compare.py`` holds the program's
readings to it.
"""

from __future__ import annotations

import gc
import subprocess
import sys
import time
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Optional

import torch

from . import compare, guard, manifest
from . import trace as trace_mod
from . import weights as weights_mod
from .peaks import peaks_for

class Feed:
    """The cell's pool of batches, in turn, for ``Trainer.fit``; keeps the
    index of every batch it hands out."""

    def __init__(self, pool: list):
        self.pool = pool
        self.served: list = []

    def __iter__(self) -> "Feed":
        return self

    def __next__(self) -> dict:
        i = len(self.served) % len(self.pool)
        self.served.append(i)
        return self.pool[i]


@dataclass
class Program:
    trainer: object
    box: list                 # [the trainer's state]: no other reference holds it
    feed: Feed
    spec: dict
    readings: dict
    anomalies: int
    step_s: float


def runtime_spec(cell: manifest.Cell, device: torch.device) -> dict:
    """The example's runtime keys, with the cell's changes, its batch and
    sequence sizes, and the platform."""
    spec = dict(cell.config["runtime"])
    spec.update(cell.workload.get("runtime", {}))
    traffic = cell.workload["traffic_params"]
    spec["batch_size"], spec["seq_len"] = int(traffic["batch_size"]), int(traffic["seq_len"])
    spec["platform"] = device.type
    return spec


def check_program(trainer, cell: manifest.Cell, spec: list) -> None:
    """Raise where the program's configuration (as the family's
    ``stated`` gives it) or optimizer is not what the configuration file
    states, or its parameters not the layout ``spec`` the benchmark
    makes."""
    c = cell.config
    stated = dict(cell.layout.stated(trainer.cfg.model))
    o = trainer.cfg.optimizer
    stated.update({f"optimizer.{k}": getattr(o, k) for k in
                   ("name", "b1", "b2", "weight_decay", "grad_clip", "schedule",
                    "min_lr_ratio")})
    want = dict(c)
    want.update({f"optimizer.{k}": v for k, v in c["optimizer"].items() if k != "eps"})
    wrong = {k: (v, want.get(k)) for k, v in stated.items() if want.get(k) != v}
    if wrong:
        raise ValueError(f"the program's {c['preset']} differs from configs/"
                         f"{c['name']}.json: {wrong}")
    shapes = {p: tuple(t.shape) for p, t in
              weights_mod.flat_paths(trainer.task.abstract_params()).items()}
    mine = {leaf.path: leaf.shape for leaf in spec}
    if shapes != mine:
        raise ValueError(f"the program's parameter layout differs from layouts/"
                         f"{c['family']}.py's: "
                         f"{sorted(set(shapes.items()) ^ set(mine.items()))[:6]}")


def _fit(prog: Program, steps: int) -> dict:
    """``steps`` more steps through ``Trainer.fit``; the state passes
    through the box so that only the trainer holds it meanwhile."""
    start = prog.box[0].step
    state, final = prog.trainer.fit(prog.feed, num_steps=start + steps, state=prog.box.pop())
    prog.box.append(state)
    return final


def _anomalies(final: dict) -> int:
    return int(final["train_anomalies_loss"]) + int(final["train_anomalies_grad"])


#: the steps the comparison follows, driven in set-up
CHECK_STEPS = 3


def program_setup(cell: manifest.Cell, seed: int, device: torch.device,
                  phases: Optional[dict] = None) -> Program:
    """The trainer, its state after the checked steps and their readings;
    ``phases`` collects each part's seconds."""
    phases = {} if phases is None else phases
    t = time.perf_counter()
    from polyaxon_tpu_torch.runtime.builtin import build_trainer

    phases["import_program"] = time.perf_counter() - t
    t = time.perf_counter()
    spec = runtime_spec(cell, device)
    trainer, _ = build_trainer(spec)
    leaves = weights_mod.leaves(cell.layout, cell.config)
    stacked = weights_mod.stacked(leaves)
    check_program(trainer, cell, leaves)
    state = trainer.init_state_from(weights_mod.nest(weights_mod.make(leaves, seed, device)))
    phases["trainer_and_weights"] = time.perf_counter() - t
    t = time.perf_counter()
    pool = cell.traffic.make_pool(seed, cell.workload["traffic_params"], cell.config)
    prog = Program(trainer=trainer, box=[state], feed=Feed(pool), spec=spec, readings={},
                   anomalies=0, step_s=0.0)
    del state
    phases["batches"] = time.perf_counter() - t
    losses, grad = [], {}
    for s in range(CHECK_STEPS):
        t0 = time.perf_counter()
        final = _fit(prog, 1)
        prog.step_s = time.perf_counter() - t0
        losses.append(float(final["loss"]))
        prog.anomalies += _anomalies(final)
        if s == 0:
            grad = compare.slice_norms(compare.program_mu_and_params(prog.box[0])[0],
                                       stacked)
        phases[f"step_{s + 1}"] = prog.step_s
    t = time.perf_counter()
    _, now = compare.program_mu_and_params(prog.box[0])
    first = weights_mod.make(leaves, seed, device)
    change = {}
    with torch.no_grad():
        for path, w in first.items():
            change.update(compare.slice_norms({path: now[path] - w}, stacked))
    del first, now
    prog.readings = {"loss": losses, "grad": grad, "change": change}
    phases["readings"] = time.perf_counter() - t
    return prog


def timed_window(prog: Program, seconds: float) -> dict:
    """Steps through ``Trainer.fit`` until ``seconds`` have passed (within
    half a step): ``{steps, seconds, anomalies, batches, calls}``, each call
    with its steps, seconds and the trainer's meter's step-time quantiles
    (ms)."""
    served = len(prog.feed.served)
    steps = anomalies = 0
    calls = []
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter()
        per = (now - t0) / steps if steps else prog.step_s
        left = t0 + seconds - now
        if left < per / 2:
            break
        n = max(1, int(left / per))
        final = _fit(prog, n)
        calls.append([n, round(time.perf_counter() - now, 4),
                      round(final["step_time_p50_ms"], 2), round(final["step_time_p95_ms"], 2)])
        steps += n
        anomalies += _anomalies(final)
    elapsed = time.perf_counter() - t0
    return {"steps": steps, "seconds": elapsed, "anomalies": anomalies,
            "batches": prog.feed.served[served:], "calls": calls}


def traced_steps(prog: Program, steps: int, sync) -> tuple:
    served = len(prog.feed.served)

    def run() -> int:
        _fit(prog, steps)
        return steps

    tr = trace_mod.profile_steps(run, sync)
    print(tr.spans.line(), file=sys.stderr, flush=True)
    return tr, prog.feed.served[served:]


def reference_readings(cell: manifest.Cell, spec: dict, seed: int, device: torch.device,
                       pool: list, *, quant: bool = False, keep_rows: float = 1.0) -> dict:
    """The family's reference over the first batches, from the same
    weights, as :func:`compare.readings`."""
    leaves = weights_mod.leaves(cell.layout, cell.config)
    first = weights_mod.make(leaves, seed, device)
    out = cell.reference.train(
        cell.config, spec, first, pool[:CHECK_STEPS],
        microbatches=int(spec.get("microbatches", 1)),
        block_tokens=int(cell.workload["reference_block_tokens"]), device=device,
        quant=quant, keep_rows=keep_rows)
    del first
    return compare.readings(out["loss"], out["mu"], out["change"], weights_mod.stacked(leaves))


def release(prog: Program, device: torch.device) -> None:
    """Drop the program's state, so that the reference has the memory."""
    prog.box.clear()
    prog.trainer = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def _flops(cell: manifest.Cell, pool: list, batches: list, key: str) -> float:
    """The ``key`` FLOPs (``model`` or ``matmul``) of the steps that ran
    ``batches`` (indices into ``pool``)."""
    tp = cell.workload["traffic_params"]
    per = [cell.counts.step_flops(cell.config, int(tp["batch_size"]), int(tp["seq_len"]),
                                  cell.traffic.loss_tokens(b))[key] for b in pool]
    return float(sum(per[i] for i in batches))


def _smi(query: str) -> Optional[str]:
    """``nvidia-smi``'s reading of the first card (None where it cannot)."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


class ForbiddenModules(RuntimeError):
    """JAX or the JAX package is loaded in the run's process."""


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, started: float) -> dict:
    """One run; returns the result line's object (its last key, ``compared``,
    holds each number compared beside its limit)."""
    cuda = device.type == "cuda"

    def sync() -> None:
        if cuda:
            torch.cuda.synchronize()

    phases = {"to_harness": time.perf_counter() - started}
    prog = program_setup(cell, seed, device, phases)
    pool = prog.feed.pool
    spec = prog.spec
    sync()
    setup_s = time.perf_counter() - started
    print("set-up seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()),
          file=sys.stderr, flush=True)
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    window = timed_window(prog, seconds)
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    print(f"window: calls [steps, s, p50 ms, p95 ms] {window['calls']}"
          + (f", allocator retries {torch.cuda.memory_stats().get('num_alloc_retries')}, "
             f"card {_smi('clocks.sm,power.draw,temperature.gpu,clocks_throttle_reasons.active')}"
             if cuda else ""), file=sys.stderr, flush=True)
    found = guard.loaded_forbidden()
    if found:
        raise ForbiddenModules(f"loaded in the run's process: {found}")
    tr = traced = None
    if trace:
        tr, traced = traced_steps(prog, int(cell.workload["profile_steps"]), sync)
    memory_peak = max(setup_peak, window_peak,
                      torch.cuda.max_memory_allocated() if cuda else 0)
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    release(prog, device)
    prog_readings, anomalies = prog.readings, prog.anomalies + window["anomalies"]
    del prog

    t0 = time.perf_counter()
    ref = reference_readings(cell, spec, seed, device, pool)
    print(f"reference seconds: {time.perf_counter() - t0:.3f}", file=sys.stderr, flush=True)
    found_gaps = compare.gaps(prog_readings, ref)
    ok, checks = compare.judge(found_gaps, cell.workload["limits"])
    correct = ok and anomalies == 0

    rows, seq = (int(cell.workload["traffic_params"][k]) for k in ("batch_size", "seq_len"))
    metrics: dict = {}
    if not trace:
        values = {"train_tokens_per_s": window["steps"] * rows * seq / window["seconds"],
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        peaks = peaks_for(kind)
        ctx = SimpleNamespace(
            config=cell.config, workload=cell.workload, spec=spec, peaks=peaks, trace=tr,
            window=dict(window, model_flops=_flops(cell, pool, window["batches"], "model")),
            traced_matmul_flops=_flops(cell, pool, traced, "matmul"),
            flash_least_s=(cell.counts.flash_least_s(
                cell.config, rows, seq, int(spec.get("microbatches", 1)), peaks)
                if peaks else None),
            window_peak_bytes=window_peak)
        for name, (entry, reader) in cell.readers.items():
            value = reader.read(ctx)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": entry["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": cell.chips,
                   "memory_peak_bytes": int(memory_peak)}
    if cuda:
        device_info["power_limit"] = _smi("power.limit")
    result = {"correct": bool(correct), "attempted": window["steps"],
              "failed": window["anomalies"], "metrics": metrics, "device": device_info}
    if tr is not None:
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_by_host}
    found = guard.loaded_forbidden()
    if found:
        raise ForbiddenModules(f"loaded in the run's process: {found}")
    checks["nonfinite_steps"] = {"value": anomalies, "limit": 0}
    result["compared"] = checks
    return result
