"""``optimizer_ms``: device time a step launched inside the program's
``train.optimizer`` ranges and what nests in them (the norms, the clip,
AdamW per leaf, the apply, the gate's read), in ms (``spans.py``). Nothing
where the trace holds no device activity or the program opened no
range."""

from port_bench import spans


def read(ctx):
    sp = spans.phases_of(ctx.trace)
    return None if sp is None else sp.phase_ms("train.optimizer")
