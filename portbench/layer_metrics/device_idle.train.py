"""``device_idle.train``: the share of a step in which no operation ran on
the card, in %: 1 minus the device's busy time a step (the union of the
device operations' intervals over the profiled steps, divided by their
number) over the time a step takes in the timed, untraced window of the
same run.  The profiler's own cost on the host stays out of it."""


def read(ctx):
    if not ctx.window_steps or not ctx.trace.kernels:
        return None
    busy = ctx.trace.busy_s() / ctx.profiled_steps
    return 100.0 * (1.0 - busy / (ctx.window_s / ctx.window_steps))
