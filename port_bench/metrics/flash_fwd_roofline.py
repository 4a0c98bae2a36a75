"""``flash_fwd_roofline``: the flash forward kernel's share of its
roofline, in %: the least time of the traced steps' launches
(``counts/``: the larger of FLOPs over the bf16 peak and bytes over HBM's,
the causal mask's visible pairs only) over the kernel's summed time.
Nothing where the kernel did not run."""


def read(ctx):
    tr = ctx.trace
    if tr is None or ctx.flash_least_s is None:
        return None
    spent = tr.seconds_by("flash_fwd")
    if spent <= 0:
        return None
    return 100.0 * ctx.flash_least_s["flash_fwd"] * tr.steps / spent
