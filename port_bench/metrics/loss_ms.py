"""``loss_ms``: device time a step launched inside the program's
``train.loss`` ranges (the head's forward and the chunked cross entropy),
in ms (``spans.py``). Nothing where the trace holds no device activity or
the program opened no range."""

from port_bench import spans


def read(ctx):
    sp = spans.phases_of(ctx.trace)
    return None if sp is None else sp.phase_ms("train.loss")
