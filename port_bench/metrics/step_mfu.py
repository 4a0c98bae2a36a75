"""``step_mfu``: the whole step's share of the card's dense bf16 peak, in
%: the model FLOPs of every step of the timed window (``counts/``: what the
inputs need, nothing recomputed) over the window's time on the host clock.
Nothing on a card the peak table does not hold."""


def read(ctx):
    if ctx.peaks is None or not ctx.window["steps"]:
        return None
    achieved = ctx.window["model_flops"] / ctx.window["seconds"]
    return 100.0 * achieved / ctx.peaks["bf16_flops"]
