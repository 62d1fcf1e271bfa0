"""Plain PyTorch versions of the tree-reduce family's kernels: the codec
decode-add (B1, B2) and the pairwise-tree column sums (B3, B4).

The CPU paths of ``ops`` run these, and ``chip_smoke.py`` holds the CUDA
kernels against them on the card, bit for bit.

Decode-add rounds as the jitted reference does: bf16 widens exactly and
adds once; int8 computes ``fma(f32(q), scale, keep)`` with one rounding
(``torch.addcmul``; a separate product and sum, ``keep + q * scale``,
rounds twice and differs from the reference in about a quarter of the
elements).

The tree sums (port of ``repro/kernels/tree_reduce/ref.py``) halve in f32:
row i adds row i + N/2, then row i + N/4, and so on, so the result does
not depend on how the rows arrived.  N must be a power of two; the ops pad
with zero rows first.  The int8 sum dequantises with the first level's add
fused: ``fma(f32(q[i]), scale[i], f32(q[i + N/2]) * scale[i + N/2])``, one
rounding for the low row's product, as the reference's interpret-mode
kernel computes it at N = 2, 4, 8 and 32 (at N = 16 XLA rounds that product
separately, one ulp apart; see ``tests/test_torch_tree_sum.py``).
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


def _levels(n: int) -> int:
    levels = n.bit_length() - 1
    if n < 1 or 1 << levels != n:
        raise ValueError(f"N={n} is not a power of two (pad the rows first)")
    return levels


def padded_rows(n: int) -> int:
    """The ops' power of two for N rows, ``1 << max(1, (N - 1).bit_length())``
    (N = 1 pads to 2, as the reference's ops do)."""
    return 1 << max(1, (n - 1).bit_length())


def pad_rows(x: torch.Tensor) -> torch.Tensor:
    """[N, ...] → [padded_rows(N), ...] with zero rows."""
    n = x.shape[0]
    n2 = padded_rows(n)
    if n2 == n:
        return x
    return torch.cat([x, x.new_zeros((n2 - n,) + tuple(x.shape[1:]))])


def _halve(acc: torch.Tensor) -> torch.Tensor:
    n = acc.shape[0]
    while n > 1:
        half = n // 2
        acc = acc[:half] + acc[half:n]
        n = half
    return acc[0]


def tree_reduce_ref(x: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """[N, D] → [D]: pairwise halving in f32, cast to ``out_dtype`` (default
    x's dtype) once.  N must be a power of two."""
    _levels(x.shape[0])
    return _halve(x.float()).to(out_dtype or x.dtype)


def linear_reduce_ref(x: torch.Tensor) -> torch.Tensor:
    """Accumulation-order baseline (left to right in f32) for the
    determinism tests."""
    acc = x[0].float()
    for i in range(1, x.shape[0]):
        acc = acc + x[i].float()
    return acc.to(x.dtype)


def int8_tree_reduce_ref(q: torch.Tensor, scale: torch.Tensor
                         ) -> torch.Tensor:
    """q [N, nb, 128] int8 + scale [N, nb, 1] f32 → [nb * 128] f32: the
    tree sum of the dequantised rows, the low row's dequant fused into the
    first add.  N must be a power of two."""
    if _levels(q.shape[0]) == 0:
        return (q.float() * scale).reshape(-1)
    half = q.shape[0] // 2
    first = torch.addcmul(q[half:].float() * scale[half:], q[:half].float(),
                          scale[:half])
    return _halve(first.reshape(half, -1))
