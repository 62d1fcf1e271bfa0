"""``mfu.train``: the model's FLOPs of the steps of the timed window (the
counts module's ``total``, recompute not counted) over the window's time
and the card's bf16 peak, in %."""


def read(ctx):
    if not ctx.window_steps:
        return None
    rate = ctx.flops["total"] * ctx.window_steps / ctx.window_s
    return 100.0 * rate / ctx.peaks["bf16_flops"]
