"""``error_feedback_roofline``: the least bytes the error feedback (E1) of
the profiled steps moves (16 B an element of every bucket's ``[world,
length]`` rows, the counts module) at the card's HBM bandwidth, over the
device time of E1's kernels (``error_feedback_kernel``), in %.  Nothing to
read where no bucket rides a codec or no such kernel ran."""


def read(ctx):
    per_step = ctx.error_feedback_bytes
    t = ctx.trace.kernel_seconds(lambda n: "error_feedback_kernel" in n)
    if not per_step or t <= 0:
        return None
    least = per_step * ctx.profiled_steps / ctx.peaks["hbm_bytes_per_s"]
    return 100.0 * least / t
