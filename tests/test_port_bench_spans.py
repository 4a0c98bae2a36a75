"""The benchmark's reduction of a traced run by the program's ``train.*``
ranges (``port_bench/spans.py``), on a hand-made Chrome trace: device time
by the range its launch sat in, idle gaps by the range at their middle,
sync calls by the range they were made in."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from port_bench import spans, trace
from port_bench.metrics import (bwd_ms, fwd_ms, host_syncs_per_step, loop_idle_ms, loss_ms,
                                optimizer_ms)

READERS = {"fwd_ms": fwd_ms, "loss_ms": loss_ms, "bwd_ms": bwd_ms,
           "optimizer_ms": optimizer_ms, "loop_idle_ms": loop_idle_ms,
           "host_syncs_per_step": host_syncs_per_step}


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(name, at, corr, start, dur, tid=1, cat="kernel"):
    """A launch call at ``at`` on host thread ``tid`` and its activity."""
    return [_x("cuda_runtime", "cudaLaunchKernel", at, 1, tid, corr),
            _x(cat, name, start, dur, 7, corr)]


def _events():
    """One step, window [0, 200): data [0, 10), step [10, 180) holding a
    forward [20, 60) with a loss [40, 60), a backward [60, 100) whose
    launches come from another thread, an optimizer [100, 160) with a sync
    [150, 160); a sync [180, 190) after the step."""
    ev = [
        _x("user_annotation", trace.WINDOW, 0, 200),
        _x("user_annotation", "train.data", 0, 10),
        _x("user_annotation", "train.step", 10, 170),
        _x("user_annotation", "train.forward", 20, 40),
        _x("user_annotation", "train.loss", 40, 20),
        _x("user_annotation", "train.backward", 60, 40),
        _x("user_annotation", "train.optimizer", 100, 60),
        _x("user_annotation", "train.sync", 150, 10),
        _x("user_annotation", "train.sync", 180, 10),
        _x("user_annotation", "unrelated.range", 0, 200),
        _x("cpu_op", "aten::mm", 20, 30),
        _x("cuda_runtime", "cudaStreamSynchronize", 151, 8),
        _x("cuda_runtime", "cudaDeviceSynchronize", 181, 8),
    ]
    ev += _launch("cast_kernel", 12, 1, 15, 5)                         # train.step
    ev += _launch("gemm_fwd", 21, 2, 22, 20)                           # train.forward
    ev += _launch("loss_exp", 41, 3, 42, 10)                           # train.loss
    ev += _launch("gemm_bwd", 61, 4, 62, 30, tid=2)                    # train.backward
    ev += _launch("adam_kernel", 101, 5, 102, 40)                      # train.optimizer
    ev += _launch("Memcpy DtoH", 150.5, 6, 150.6, 0.4, cat="gpu_memcpy")  # the gate's read
    ev.append(_x("kernel", "orphan", 170, 5, 7, 99))                   # no launch traced
    return ev


def test_each_device_activity_goes_to_the_range_its_launch_sat_in():
    sp = spans.reduce({"traceEvents": _events()}, steps=1)
    assert sp.ranges == 8
    d = sp.device_us
    assert d[("train.step",)] == pytest.approx(5)
    assert d[("train.step", "train.forward")] == pytest.approx(20)
    # nested ranges: the innermost
    assert d[("train.step", "train.forward", "train.loss")] == pytest.approx(10)
    # launched from the autograd engine's thread while the main thread waits
    assert d[("train.step", "train.backward")] == pytest.approx(30)
    assert d[("train.step", "train.optimizer")] == pytest.approx(40)
    assert d[("train.step", "train.optimizer", "train.sync")] == pytest.approx(0.4)
    assert d[spans.UNLAUNCHED] == pytest.approx(5)
    assert sp.phase_ms("train.forward") == pytest.approx(0.020)
    assert sp.phase_ms("train.loss") == pytest.approx(0.010)
    assert sp.phase_ms("train.backward") == pytest.approx(0.030)
    # the optimizer holds what nests in it
    assert sp.phase_ms("train.optimizer") == pytest.approx(0.0404)


def test_idle_gaps_go_to_the_range_at_their_middle_and_outside_the_phases_to_the_loop():
    sp = spans.reduce({"traceEvents": _events()}, steps=2)
    idle = sp.idle_us
    # busy [15,20) [22,42) [42,52) [62,92) [102,142) [150.6,151) [170,175)
    assert idle[("train.data",)] == pytest.approx(15)                      # [0, 15)
    assert idle[("train.step", "train.forward")] == pytest.approx(2)       # [20, 22)
    assert idle[("train.step", "train.forward", "train.loss")] == pytest.approx(10)
    assert idle[("train.step", "train.backward")] == pytest.approx(10)     # [92, 102)
    assert idle[("train.step", "train.optimizer")] == pytest.approx(8.6)   # [142, 150.6)
    assert idle[("train.step",)] == pytest.approx(19)                      # [151, 170)
    assert idle[("train.sync",)] == pytest.approx(25)                      # [175, 200)
    # the gaps are trace.reduce's
    tr = trace.reduce({"traceEvents": _events()}, steps=2, window_s=2e-4)
    assert sum(idle.values()) / 1e6 == pytest.approx(sum(v for _, v in tr.idle_by_host))
    assert sp.loop_idle_ms() == pytest.approx((15 + 19 + 25) / 2 / 1e3)


def test_sync_calls_are_counted_under_their_range():
    sp = spans.reduce({"traceEvents": _events()}, steps=1)
    assert sp.syncs == {("train.step", "train.optimizer", "train.sync"): 1,
                        ("train.sync",): 1}
    table = sp.by_range()
    assert table["train.sync"][2] == 2
    assert table["train.loss"][0] == pytest.approx(0.010)
    assert "train.sync" in sp.line() and "(no launch found)" in sp.line()


def test_the_traces_own_fields_are_the_same_with_ranges_in_it():
    plain = [e for e in _events() if not e["name"].startswith("train.")]
    a = trace.reduce.plain({"traceEvents": plain}, steps=1, window_s=2e-4)
    b = trace.reduce({"traceEvents": _events()}, steps=1, window_s=2e-4)
    assert a.kernels == b.kernels and a.busy_s == b.busy_s
    assert a.device_ops() == b.device_ops()
    # the gaps by innermost host op ignore the ranges
    assert a.idle_by_host == b.idle_by_host
    assert not hasattr(a, "spans") and b.spans.ranges == 8


def test_the_readers_read_the_phases_and_nothing_where_nothing_ran():
    tr = trace.reduce({"traceEvents": _events()}, steps=1, window_s=2e-4)
    got = {name: r.read(SimpleNamespace(trace=tr)) for name, r in READERS.items()}
    assert got == pytest.approx({"fwd_ms": 0.020, "loss_ms": 0.010, "bwd_ms": 0.030,
                                 "optimizer_ms": 0.0404, "loop_idle_ms": 0.059,
                                 "host_syncs_per_step": 2})
    # a CPU run: ranges, no device activity
    cpu = [e for e in _events() if e["cat"] in ("user_annotation", "cpu_op")]
    tr = trace.reduce({"traceEvents": cpu}, steps=1, window_s=2e-4)
    assert all(r.read(SimpleNamespace(trace=tr)) is None for r in READERS.values())
    # a program without ranges: only the sync count reads
    bare = [e for e in _events() if not e["name"].startswith("train.")]
    tr = trace.reduce({"traceEvents": bare}, steps=1, window_s=2e-4)
    got = {name: r.read(SimpleNamespace(trace=tr)) for name, r in READERS.items()}
    assert got == {**{n: None for n in READERS}, "host_syncs_per_step": 2}
    # an untraced run
    assert all(r.read(SimpleNamespace(trace=None)) is None for r in READERS.values())


def _edges():
    """A window [10, 100) that kernels overlap, abut and straddle at both
    ends, a fill inside it and a kernel wholly after it."""
    return [
        _x("user_annotation", trace.WINDOW, 10, 90),
        _x("kernel", "a", 0, 20, 7), _x("kernel", "b", 15, 15, 7),
        _x("kernel", "c", 30, 10, 7), _x("gpu_memset", "Memset", 50, 0.5, 7),
        _x("kernel", "d", 90, 30, 7), _x("kernel", "e", 150, 10, 7),
    ]


@pytest.mark.parametrize("events", [
    _events(),
    [e for e in _events() if e["name"] != trace.WINDOW],
    _edges(),
    [e for e in _edges() if e["name"] != trace.WINDOW],
    [e for e in _events() if e["cat"] in ("user_annotation", "cpu_op")],
], ids=["step", "step-no-window", "edges", "edges-no-window", "no-device"])
def test_the_idle_gaps_are_trace_reduces_own_one_by_one(events, monkeypatch):
    """``spans.idle_gaps`` repeats ``trace.reduce``'s gap rule (the
    benchmark's older file stays as it was): the gap lists must be equal,
    each gap's ends alike, not only their sums."""
    seen = {"trace": [], "spans": []}
    by_host = trace._by_host

    def trace_gaps(gaps, evs, *a, **kw):
        seen["trace"] = list(gaps)
        return by_host(gaps, evs, *a, **kw)

    gap_rule = spans.idle_gaps

    def spans_gaps(*a):
        seen["spans"] = gap_rule(*a)
        return seen["spans"]

    monkeypatch.setattr(trace, "_by_host", trace_gaps)
    monkeypatch.setattr(spans, "idle_gaps", spans_gaps)
    trace.reduce.plain({"traceEvents": events}, steps=1, window_s=1e-4)
    spans.reduce({"traceEvents": events}, steps=1)
    assert seen["spans"] == seen["trace"]
