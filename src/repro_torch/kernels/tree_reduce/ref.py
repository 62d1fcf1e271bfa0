"""Plain PyTorch versions of the codec decode-add kernels (B1, B2).

The CPU path of ``ops.decode_add`` runs these, and ``chip_smoke.py`` holds
the CUDA kernels against them on the card, bit for bit.  Both round as the
jitted reference does: bf16 widens exactly and adds once; int8 computes
``fma(f32(q), scale, keep)`` with one rounding (``torch.addcmul``; a
separate product and sum, ``keep + q * scale``, rounds twice and differs
from the reference in about a quarter of the elements).
"""

from __future__ import annotations

import torch

CODEC_BLOCK = 128


def decode_add_bf16(keep: torch.Tensor, wire: torch.Tensor) -> torch.Tensor:
    """keep (f32) + f32(wire (bf16)), elementwise, in keep's shape."""
    return keep + wire.reshape(keep.shape).to(keep.dtype)


def decode_add_int8(keep: torch.Tensor, q: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """keep (f32) + f32(q) * scale per block of 128 consecutive elements,
    one rounding: q has keep's element count, scale one f32 per block."""
    nb = keep.numel() // CODEC_BLOCK
    out = torch.addcmul(keep.reshape(nb, CODEC_BLOCK),
                        q.reshape(nb, CODEC_BLOCK).to(keep.dtype),
                        scale.reshape(nb, 1))
    return out.reshape(keep.shape)
