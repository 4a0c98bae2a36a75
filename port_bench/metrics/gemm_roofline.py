"""``gemm_roofline``: the matrix products' share of their roofline, in %:
the traced steps' projection and head FLOPs (``counts/``) at the dense bf16
peak, over the summed time of the cuBLAS kernels (``kernels.py``'s
``gemm``). Nothing where no such kernel ran or the card has no peak."""


def read(ctx):
    tr = ctx.trace
    if tr is None or ctx.peaks is None:
        return None
    spent = tr.seconds_by("gemm")
    if spent <= 0:
        return None
    return 100.0 * ctx.traced_matmul_flops / ctx.peaks["bf16_flops"] / spent
