"""``flash_bwd_roofline``: the flash backward kernels' (dQ and dK/dV
together) share of their roofline, in %: the least time of the traced
steps' launches (``counts/``) over the two kernels' summed time. Nothing
where they did not run."""


def read(ctx):
    tr = ctx.trace
    if tr is None or ctx.flash_least_s is None:
        return None
    spent = tr.seconds_by("flash_bwd")
    if spent <= 0:
        return None
    return 100.0 * ctx.flash_least_s["flash_bwd"] * tr.steps / spent
