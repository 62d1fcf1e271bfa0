"""Plain PyTorch version of the blocked GEMM kernel (B6).

Port of ``repro/kernels/gemm/ref.py``: ``[M, K] @ [K, N]`` accumulated in
f32 and rounded once to the output dtype (x's by default).  ``ops.gemm``
runs it for CPU tensors and ``chip_smoke.py`` holds the CUDA kernel
against it on the card, where it runs in full f32 (TF32 off).
"""

from __future__ import annotations

import torch


def gemm_ref(x: torch.Tensor, y: torch.Tensor, out_dtype=None
             ) -> torch.Tensor:
    """x [M, K] @ y [K, N] → [M, N]: f32 products and sums, one rounding
    to ``out_dtype`` (default x's dtype)."""
    return torch.matmul(x.float(), y.float()).to(out_dtype or x.dtype)
