"""``launches_per_step``: device kernels in the trace of the traced steps,
per step."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.kernels or not tr.steps:
        return None
    return len(tr.kernels) / tr.steps
