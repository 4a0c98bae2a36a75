"""``device_idle_pct``: the share of a timed step in which no kernel, copy
or fill ran on the device, in %: one minus the device's busy time a step in
the trace of the traced steps over the timed window's time a step. The
traced steps' own wall time is not the denominator: under the profiler
every launch pays CUPTI's host cost, which lengthens the gaps."""


def read(ctx):
    tr, window = ctx.trace, ctx.window
    if tr is None or tr.busy_s <= 0 or not tr.steps or not window["steps"]:
        return None
    step_s = window["seconds"] / window["steps"]
    return 100.0 * (1.0 - tr.busy_s / tr.steps / step_s)
