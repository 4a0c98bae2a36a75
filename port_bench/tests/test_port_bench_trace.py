"""The trace's reduction, the phases by range and the readers of the
phases, on a generated trace of three steps, against the numbers the
benchmark read before ``trace.reduce`` filled ``Trace.spans`` itself (when
``spans.py`` wrapped it and found the gaps by a copy of its rule): the same
gaps, the same device and idle time under each nest of ranges, the same
sync calls and the same six metrics."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

from port_bench import trace
from port_bench.metrics import (bwd_ms, fwd_ms, host_syncs_per_step, loop_idle_ms, loss_ms,
                                optimizer_ms)

READERS = {"fwd_ms": fwd_ms, "loss_ms": loss_ms, "bwd_ms": bwd_ms,
           "optimizer_ms": optimizer_ms, "loop_idle_ms": loop_idle_ms,
           "host_syncs_per_step": host_syncs_per_step}


def generated_trace(seed: int = 23, steps: int = 3) -> list:
    """A training loop's Chrome events: per step a data range with its
    copy, a step range with two microbatches (forward holding the loss,
    a backward launched from a second thread), an optimizer with a sync
    and its read, then a sync after the step; a second stream's kernels
    overlapping the first's, a kernel with no traced launch, and the
    window cutting the last kernels."""
    rng = np.random.default_rng(seed)
    ev: list = []
    clock = {"host": 100.0, "dev": 100.0, "corr": 0}

    def x(cat, name, ts, dur, tid=1, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": float(ts), "dur": float(dur),
             "tid": tid}
        if corr is not None:
            e["args"] = {"correlation": corr}
        ev.append(e)

    def launch(name, tid=1, cat="kernel", stream=7):
        clock["corr"] += 1
        at = clock["host"] + float(rng.uniform(0.5, 4.0))
        if rng.random() < 0.2:      # the host falls behind: the device idles
            at += float(rng.exponential(40.0))
        x("cuda_runtime", "cudaLaunchKernel", at, 1.5, tid, clock["corr"])
        start = max(clock["dev"], at + float(rng.uniform(2.0, 9.0)))
        dur = float(rng.uniform(0.5, 30.0))
        x(cat, name, start, dur, stream, clock["corr"])
        if stream == 7:
            clock["dev"] = start + dur
        clock["host"] = at + 1.5

    def ranged(name, body):
        start = clock["host"]
        clock["host"] += float(rng.uniform(0.2, 2.0))
        body()
        clock["host"] += float(rng.uniform(0.2, 2.0))
        x("user_annotation", name, start, clock["host"] - start)

    def sync(name):
        at = clock["host"]
        done = max(at + 1.0, clock["dev"] + 0.5)
        x("cuda_runtime", name, at, done - at)
        clock["host"] = done + float(rng.uniform(0.5, 3.0))

    def data():
        x("cpu_op", "aten::copy_", clock["host"], 6.0)
        launch("Memcpy HtoD (Pageable -> Device)", cat="gpu_memcpy")
        clock["host"] += float(rng.uniform(5.0, 40.0))

    def forward():
        for _ in range(int(rng.integers(3, 7))):
            launch("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTN")
            launch("void at::native::vectorized_elementwise_kernel<4>")
        ranged("train.loss", lambda: [launch("lm_loss_rows_kernel")
                                      for _ in range(int(rng.integers(1, 3)))])

    def backward():
        for _ in range(int(rng.integers(4, 9))):
            launch("void flash_bwd_dkv_wgmma_kernel<64>(CUtensorMap)", tid=2)
        if rng.random() < 0.7:
            launch("void at::native::reduce_kernel<512, 1>", tid=2, stream=8)

    def microbatch():
        ranged("train.forward", forward)
        ranged("train.backward", backward)

    def optimizer():
        for _ in range(int(rng.integers(5, 12))):
            launch("multi_tensor_apply_kernel")

        def gate():
            launch("Memcpy DtoH (Device -> Pageable)", cat="gpu_memcpy")
            sync("cudaStreamSynchronize")
        ranged("train.sync", gate)

    def step():
        ranged("train.microbatch", microbatch)
        ranged("train.microbatch", microbatch)
        ranged("train.optimizer", optimizer)

    start = clock["host"]
    for _ in range(steps):
        ranged("train.data", data)
        ranged("train.step", step)
        x("cpu_op", "aten::item", clock["host"], 3.0)
        ranged("train.sync", lambda: sync("cudaDeviceSynchronize"))
        clock["host"] += float(rng.uniform(1.0, 20.0))
    x("kernel", "orphan_kernel", clock["dev"] - 5.0, 3.0, 7, 10_000)
    launch("void at::native::vectorized_elementwise_kernel<4>")
    x("user_annotation", trace.WINDOW, start, clock["dev"] - 2.0 - start)
    return ev


# read before Trace.spans moved into trace.reduce, from this trace
FROZEN_TRACE = {
    "kernels": 128,
    "busy_s": 0.0019322689297255496,
    "idle_by_host": [["(python between ops)", 0.00023064197304635683]],
}
FROZEN_SPANS = {
    "ranges": 39,
    "device_us": {
        ("train.data",): 62.05872028337154,
        ("train.step", "train.microbatch", "train.forward"): 897.4628807874216,
        ("train.step", "train.microbatch", "train.forward", "train.loss"): 135.03089641841035,
        ("train.step", "train.microbatch", "train.backward"): 608.7985769711136,
        ("train.step", "train.optimizer"): 213.57656673884253,
        ("train.step", "train.optimizer", "train.sync"): 39.6282185226047,
        ("(no launch found)",): 3.0,
        (): 3.8872218636797697,
    },
    "idle_us": {
        ("train.data",): 40.23335342945674,
        (): 88.94892980998247,
        ("train.step", "train.microbatch"): 21.308688928572337,
        ("train.step", "train.microbatch", "train.forward"): 76.88164287841573,
        ("train.step", "train.microbatch", "train.forward", "train.loss"): 3.2693579999295252,
    },
    "syncs": {
        ("train.step", "train.optimizer", "train.sync"): 3.0,
        ("train.sync",): 3.0,
    },
}
FROZEN_METRICS = {
    "fwd_ms": 0.2991542935958072,
    "loss_ms": 0.04501029880613678,
    "bwd_ms": 0.2029328589903712,
    "optimizer_ms": 0.08440159508714908,
    "loop_idle_ms": 0.05016365738933718,
    "host_syncs_per_step": 2.0,
}


def test_the_reduction_reads_as_it_did_before_the_spans_moved_into_it():
    tr = trace.reduce({"traceEvents": generated_trace()}, steps=3, window_s=1e-3)
    assert {"kernels": len(tr.kernels), "busy_s": tr.busy_s,
            "idle_by_host": tr.idle_by_host} == FROZEN_TRACE
    sp = tr.spans
    assert {"ranges": sp.ranges, "device_us": sp.device_us, "idle_us": sp.idle_us,
            "syncs": sp.syncs} == FROZEN_SPANS
    got = {name: r.read(SimpleNamespace(trace=tr)) for name, r in READERS.items()}
    assert got == FROZEN_METRICS
    # every idle microsecond of the window is under some nest, once
    assert sum(sp.idle_us.values()) / 1e6 == pytest.approx(
        sum(v for _, v in tr.idle_by_host), rel=1e-12)
