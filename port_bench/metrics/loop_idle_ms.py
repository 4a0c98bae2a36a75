"""``loop_idle_ms``: device idle a step whose middle lies outside the
program's ``train.forward``, ``train.loss``, ``train.backward`` and
``train.optimizer`` ranges (the batch, its copy and the casts at the
step's start, the host reads, the fit loop's hooks), in ms
(``spans.py``; the gaps are ``trace.py``'s). Nothing where the trace holds
no device activity or the program opened no range."""

from port_bench import spans


def read(ctx):
    sp = spans.phases_of(ctx.trace)
    return None if sp is None else sp.loop_idle_ms()
