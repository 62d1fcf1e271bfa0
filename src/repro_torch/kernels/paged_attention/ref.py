"""Plain PyTorch version of the paged-attention decode kernel.

The gather-then-attend computation the CUDA kernel fuses away (port of
``repro/kernels/paged_attention/ref.py``): gather the virtual
[B, n*bs, ...] KV view from the pool, then a dense masked-softmax attention
over it.  Masking is by virtual position only — valid keys of row b are
positions ``< lengths[b]`` (and, with a window, ``length-1-pos < window``)
— which hides both future positions and whatever sentinel-padded table
entries gather.  ``ops.paged_attention`` runs it for CPU tensors, and
``chip_smoke.py`` holds the kernel against it on the card.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _gather(pool, tables):
    """pool [N, bs, ...] + tables [B, n] → virtual view [B, n*bs, ...]."""
    B, n = tables.shape
    bs = pool.shape[1]
    g = pool.index_select(0, tables.reshape(-1))
    return g.reshape((B, n * bs) + tuple(pool.shape[2:]))


def paged_attention_ref(q, k_pool, v_pool, tables, lengths, *, scale: float,
                        window=None, softcap=None):
    """q: [B, Hkv, G, d], pools: [N, bs, Hkv, d(v)], tables: [B, n],
    lengths: [B] → [B, Hkv, G, dv]."""
    k = _gather(k_pool, tables)                       # [B, S, Hkv, d]
    v = _gather(v_pool, tables)                       # [B, S, Hkv, dv]
    S = k.shape[1]
    s = torch.einsum("bhgd,bshd->bhgs", q, k).float() * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(S, dtype=torch.int32, device=q.device)[None, None,
                                                              None, :]
    length = lengths.to(torch.int32)[:, None, None, None]
    mask = pos < length
    if window is not None:
        mask &= (length - 1 - pos) < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgs,bshd->bhgd", p.to(v.dtype), v).to(q.dtype)
