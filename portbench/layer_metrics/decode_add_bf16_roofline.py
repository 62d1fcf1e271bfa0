"""``decode_add_bf16_roofline``: the least bytes the bf16 decode-adds (B1)
of the profiled steps move (10 B an element, the counts module) at the
card's HBM bandwidth, over the device time of B1's kernels, in %.  Nothing
to read where no bucket rides the bf16 codec."""


def read(ctx):
    per_step = ctx.decode_add_bytes.get("bf16")
    t = ctx.trace.kernel_seconds(lambda n: "decode_add_bf16" in n)
    if not per_step or t <= 0:
        return None
    least = per_step * ctx.profiled_steps / ctx.peaks["hbm_bytes_per_s"]
    return 100.0 * least / t
