"""``host_syncs_per_step``: synchronising CUDA runtime calls
(``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize``) in the trace of the traced steps, under any range
or none, per step (``spans.py``). Nothing where the trace holds no device
activity."""

from port_bench import spans


def read(ctx):
    sp = spans.of(ctx.trace)
    return None if sp is None else sum(sp.syncs.values()) / sp.steps
