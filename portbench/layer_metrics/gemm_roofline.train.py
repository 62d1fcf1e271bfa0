"""``gemm_roofline.train``: the FLOPs of the profiled steps that run as
GEMMs, at the card's bf16 peak, over the device time of the GEMM kernels
of those steps, in %.  The port runs attention's score and value products
as batched cuBLAS GEMMs (``torch.einsum``), so the counted FLOPs are the
counts module's ``matmul`` (the dense layers and the head) and
``attention`` (the causal pairs), recompute not counted."""

GEMM_MARKS = ("gemm", "nvjet", "xmma", "cutlass")


def is_gemm(name: str) -> bool:
    low = name.lower()
    return "decode_add" not in low and any(m in low for m in GEMM_MARKS)


def read(ctx):
    t = ctx.trace.kernel_seconds(is_gemm)
    if t <= 0:
        return None
    flops = ctx.flops["matmul"] + ctx.flops["attention"]
    least = flops * ctx.profiled_steps / ctx.peaks["bf16_flops"]
    return 100.0 * least / t
