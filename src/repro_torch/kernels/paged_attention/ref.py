"""Plain PyTorch versions of the paged-attention decode kernels (GQA, B7;
absorbed MLA, B8).

The gather-then-attend computations the CUDA kernels fuse away (port of
``repro/kernels/paged_attention/ref.py``): gather the virtual
[B, n*bs, ...] KV view from the pool, then a dense masked-softmax attention
over it.  Masking is by virtual position only — valid keys of row b are
positions ``< lengths[b]`` (and, with a window, ``length-1-pos < window``)
— which hides both future positions and whatever sentinel-padded table
entries gather.  ``ops.paged_attention`` and ``ops.paged_mla_attention`` run them for CPU
tensors, and ``chip_smoke.py`` holds the kernels against them on the
card.
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


def paged_mla_attention_ref(q_eff, q_rope, ckv_pool, kr_pool, tables,
                            lengths, *, scale: float):
    """q_eff: [B, H, r], q_rope: [B, H, dr], ckv_pool: [N, bs, r],
    kr_pool: [N, bs, dr], tables: [B, n], lengths: [B] → [B, H, r].

    ``c_kv`` is both the key's latent part and the value; the softmax is
    rounded to the pool dtype before the PV product, as the reference."""
    c_kv = _gather(ckv_pool, tables)                  # [B, S, r]
    k_r = _gather(kr_pool, tables)                    # [B, S, dr]
    S = c_kv.shape[1]
    s = torch.einsum("bhr,bsr->bhs", q_eff, c_kv).float()
    s = s + torch.einsum("bhd,bsd->bhs", q_rope, k_r).float()
    s = s * scale
    pos = torch.arange(S, dtype=torch.int32, device=q_eff.device)[None,
                                                                  None, :]
    valid = pos < lengths.to(torch.int32)[:, None, None]
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bsr->bhr", p.to(c_kv.dtype),
                        c_kv).to(q_eff.dtype)
