"""``nonmatmul_ms_per_step``: device time a step in kernels that are
neither cuBLAS's products nor the port's flash kernels (elementwise, norms,
casts, the loss's and the optimizer's kernels), in ms."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.kernels or not tr.steps:
        return None
    return 1e3 * tr.seconds_by("other") / tr.steps
