"""``decode_add_int8_roofline``: the least bytes the int8 decode-adds (B2)
of the profiled steps move (9.03 B an element, the counts module) at the
card's HBM bandwidth, over the device time of B2's kernels, in %.  Nothing
to read where no bucket rides the int8 codec."""


def read(ctx):
    per_step = ctx.decode_add_bytes.get("int8")
    t = ctx.trace.kernel_seconds(lambda n: "decode_add_int8" in n)
    if not per_step or t <= 0:
        return None
    least = per_step * ctx.profiled_steps / ctx.peaks["hbm_bytes_per_s"]
    return 100.0 * least / t
