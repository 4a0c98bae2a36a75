"""``peak_mem_gib``: the caching allocator's peak of allocated device memory
over the timed window (``torch.cuda.max_memory_allocated`` after
``reset_peak_memory_stats`` at its start), in GiB."""


def read(ctx):
    return ctx.window_peak_bytes / 2 ** 30 if ctx.window_peak_bytes else None
