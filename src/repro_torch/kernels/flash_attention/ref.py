"""Plain PyTorch version of the flash-attention forward kernel (B5).

Port of ``repro/kernels/flash_attention/ref.py``: a dense masked softmax
attention over flattened heads, q [BH, Tq, D], k [BH, Tk, D],
v [BH, Tk, Dv] → [BH, Tq, Dv].  The product q k^T is taken in the inputs'
dtype and scaled in f32, the softcap follows the scale, masked scores are
-1e30, the softmax is f32 and rounded to v's dtype before it weights V,
and the output is in q's dtype.  The causal mask is top-left aligned (key
j <= query i, both counted from 0).

A row that sees no key at all (every score -1e30) comes out as the mean of
every V row, as in the reference; the kernel returns 0 there, and the
comparisons leave such rows out.

``ops.flash_attention`` runs it for CPU tensors and recomputes through it
for the backward; ``chip_smoke.py`` holds the kernel against it on the
card.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_mask(Tq: int, Tk: int, *, causal=True, window=None,
                   device=None) -> torch.Tensor:
    """[Tq, Tk] bool: which keys each query row sees."""
    q_pos = torch.arange(Tq, device=device)[:, None]
    k_pos = torch.arange(Tk, device=device)[None, :]
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    return mask


def flash_attention_ref(q, k, v, *, causal=True, window=None, softcap=None):
    """q: [BH, Tq, D], k: [BH, Tk, D], v: [BH, Tk, Dv] → [BH, Tq, Dv], the
    scores scaled by 1/sqrt(D)."""
    Tq, D = q.shape[1], q.shape[2]
    Tk = k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q, k).float() * (1.0 / math.sqrt(D))
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = attention_mask(Tq, Tk, causal=causal, window=window,
                          device=q.device)
    s = torch.where(mask[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bqk,bkd->bqd", p, v).to(q.dtype)
