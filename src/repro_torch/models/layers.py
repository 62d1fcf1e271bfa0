"""Model building blocks (port of ``repro/models/layers.py``).

Plain functions on tensors: parameters are nested dicts of tensors, and
every layer is an (init, apply) pair.  Conventions kept from the
reference so the parity tests compare like with like:

  * ``dense`` is ``x @ w`` with ``w`` as [d_in, d_out];
  * ``rms_norm`` has no ``1 +`` offset on the scale;
  * rope is half-split (not interleaved);
  * softmax and normalisers run in f32, activations in the param dtype;
  * attention is GQA-grouped (KV heads are never replicated in memory).

Slice 1 ports what paged serving of dense GQA models reaches: the
unchunked attention core, the paged KV primitives, GQA attention and the
gated MLPs.  Blocked (training-length) attention, the contiguous KV cache,
MLA and MoE raise ``NotImplementedError`` naming the slice that brings
them.

The paged primitives update the pool IN PLACE (``paged_scatter``,
``copy_block``) and return it: the pools are the largest tensors of a
serve run, and nothing needs the pre-write value.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.paged_attention.ops import paged_attention

QUERY_CHUNK_THRESHOLD = 2_048    # from here on the reference blocks queries


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _normal(shape, std, *, dtype, device, generator):
    """N(0, std²) drawn in f32 and cast (the reference's init recipe);
    shapes only on the ``meta`` device."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (w * std).to(dtype)


def _init_dense(d_in, d_out, *, dtype, device, generator, scale=None,
                bias=False):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": _normal((d_in, d_out), scale, dtype=dtype, device=device,
                      generator=generator)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# ---------------------------------------------------------------------------
# Norms / positional encodings
# ---------------------------------------------------------------------------


def init_rmsnorm(d, *, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rms_norm(p, x, eps):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [..., T, H, D]; positions: [..., T] (broadcastable)."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, device=x.device)           # [D/2]
    ang = positions[..., None].float() * inv              # [..., T, D/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# Attention core (GQA, masks)
# ---------------------------------------------------------------------------


def _mask_bias(pos_q, pos_k, *, causal, window, prefix_len):
    """Additive f32 bias [..., Tq, Tk] built from position comparisons."""
    pq = pos_q[..., :, None]
    pk = pos_k[..., None, :]
    ok = torch.ones(torch.broadcast_shapes(pq.shape, pk.shape),
                    dtype=torch.bool, device=pos_q.device)
    if causal:
        allowed = pk <= pq
        if prefix_len is not None:
            allowed = allowed | (pk < prefix_len)
        ok &= allowed
    if window is not None:
        ok &= (pq - pk) < window
    zero = torch.zeros((), dtype=torch.float32, device=pos_q.device)
    return torch.where(ok, zero, float("-inf"))


def gqa_attention(q, k, v, *, pos_q, pos_k, causal=True, window=None,
                  prefix_len=None, attn_cap=None, scale=None) -> torch.Tensor:
    """q: [B,Tq,Hq,Dk]  k: [B,Tk,Hkv,Dk]  v: [B,Tk,Hkv,Dv] → [B,Tq,Hq,Dv].

    The unchunked branch of the reference: scores for every (query, key)
    pair at once.  The reference's chunked branches (online softmax over
    long KV, checkpointed query blocks for training) come with the
    training slice.
    """
    B, Tq, Hq, Dk = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    Dv = v.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(Dk)
    qg = q.reshape(B, Tq, Hkv, G, Dk) * scale
    if pos_q.ndim == 1:
        pos_q = pos_q[None, :].expand(B, Tq)
    if pos_k.ndim == 1:
        pos_k = pos_k[None, :].expand(B, k.shape[1])
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float()
    s = softcap(s, attn_cap)
    s = s + _mask_bias(pos_q, pos_k, causal=causal, window=window,
                       prefix_len=prefix_len)[:, None, None]
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v)
    return o.reshape(B, Tq, Hq, Dv)


# ---------------------------------------------------------------------------
# Paged KV cache primitives (pool [num_blocks, block_size, ...] + block table)
# ---------------------------------------------------------------------------
#
# One pooled tensor [num_blocks, block_size, ...] per cache leaf; each slot
# maps virtual positions onto physical blocks through a fixed-width block
# table [B, n_max] (unallocated entries padded with the SENTINEL block 0,
# whose contents are garbage by construction and masked everywhere).

PAGED_SENTINEL = 0


def paged_gather(pool, tables):
    """pool [N, bs, ...] + tables [B, n] -> virtual view [B, n*bs, ...].

    Virtual position p of row b lives at pool[tables[b, p // bs], p % bs].
    """
    B, n = tables.shape
    bs = pool.shape[1]
    g = pool.index_select(0, tables.reshape(-1))          # [B*n, bs, ...]
    return g.reshape((B, n * bs) + tuple(pool.shape[2:]))


def paged_scatter(pool, new, tables, offset):
    """Write ``new`` [B,T,...] at virtual positions [offset, offset+T)
    through ``tables`` [B, n] into ``pool`` [N, bs, ...], IN PLACE; returns
    ``pool``.

    ``offset`` is a scalar (chunked prefill; shared start) or a per-row
    [B] vector.  Positions beyond the table's span are redirected to the
    SENTINEL block instead of clamping onto a live block; masked decode
    rows carry an all-sentinel table row, so their writes land there too.
    """
    bs = pool.shape[1]
    B, T = new.shape[:2]
    n = tables.shape[1]
    dev = pool.device
    off = torch.as_tensor(offset, dtype=torch.int64, device=dev)
    ar = torch.arange(T, dtype=torch.int64, device=dev)
    if off.ndim == 0:
        pos = (off + ar)[None, :].expand(B, T)
    else:
        pos = off[:, None] + ar[None, :]
    bi = pos // bs
    blk = torch.gather(tables.to(torch.int64), 1, bi.clamp(0, n - 1))
    blk = torch.where(bi < n, blk, torch.full_like(blk, PAGED_SENTINEL))
    flat = new.reshape((B * T,) + tuple(new.shape[2:])).to(pool.dtype)
    pool[blk.reshape(-1), (pos % bs).reshape(-1)] = flat
    return pool


# ---------------------------------------------------------------------------
# GQA attention layer (projections + rope + cache)
# ---------------------------------------------------------------------------


def init_attention(cfg: ArchConfig, *, device, generator):
    dt = _dtype(cfg)
    D, H, Hkv, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kw = dict(dtype=dt, device=device, generator=generator)
    p = {
        "wq": _init_dense(D, H * Dh, bias=cfg.qkv_bias, **kw),
        "wk": _init_dense(D, Hkv * Dh, bias=cfg.qkv_bias, **kw),
        "wv": _init_dense(D, Hkv * Dh, bias=cfg.qkv_bias, **kw),
        "wo": _init_dense(H * Dh, D, scale=1.0 / math.sqrt(H * Dh), **kw),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(Dh, dtype=dt, device=device)
        p["k_norm"] = init_rmsnorm(Dh, dtype=dt, device=device)
    return p


def apply_attention(p, cfg: ArchConfig, x, *, positions, kv_cache=None,
                    cache_offset=None, window=None, prefix_len=None,
                    block_tables=None, paged_kernel="auto"):
    """x: [B,T,D]. Returns (out [B,T,D], new_kv or None).

    Paged mode only: ``kv_cache`` leaves are pools [N, bs, Hkv, Dh] (written
    in place) and ``block_tables`` [B, n] map virtual positions onto
    physical blocks; ``cache_offset`` is a scalar or per-row [B] count of
    tokens already cached.  ``paged_kernel="auto"`` (the default) routes
    T==1 decode through ``kernels.paged_attention`` (the CUDA kernel on a
    CUDA pool, its plain version on a CPU pool); ``"ref"`` keeps the
    reference's gather-then-attend lowering."""
    B, T, D = x.shape
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = dense(p["wq"], x).reshape(B, T, H, Dh)
    k = dense(p["wk"], x).reshape(B, T, Hkv, Dh)
    v = dense(p["wv"], x).reshape(B, T, Hkv, Dh)
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_norm(p["k_norm"], k, cfg.norm_eps)
    if cfg.pos_embed != "rope":
        raise NotImplementedError(
            f"pos_embed {cfg.pos_embed!r} comes with port slice 3")
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if kv_cache is None:
        if T >= QUERY_CHUNK_THRESHOLD:
            raise NotImplementedError(
                "training-length attention (blocked query chunks) comes "
                "with port slice 2")
        o = gqa_attention(q, k, v, pos_q=positions, pos_k=positions,
                          causal=True, window=window, prefix_len=prefix_len,
                          attn_cap=cfg.attn_softcap)
        new_kv = {"k": k, "v": v}
    else:
        if block_tables is None:
            raise NotImplementedError(
                "the contiguous KV cache is not ported yet; slice 1 serves "
                "from the paged cache only")
        k_pool = paged_scatter(kv_cache["k"], k, block_tables, cache_offset)
        v_pool = paged_scatter(kv_cache["v"], v, block_tables, cache_offset)
        new_kv = {"k": k_pool, "v": v_pool}
        if paged_kernel not in ("auto", "ref"):
            raise ValueError(f"unknown paged_kernel {paged_kernel!r}")
        if T == 1 and paged_kernel == "auto" and prefix_len is None:
            o = paged_attention(q, k_pool, v_pool, block_tables,
                                cache_offset, window=window,
                                softcap=cfg.attn_softcap)
            out = dense(p["wo"], o.reshape(B, T, H * Dh))
            return out, new_kv
        k_all = paged_gather(k_pool, block_tables)
        v_all = paged_gather(v_pool, block_tables)
        S = k_all.shape[1]
        pos_k = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
        pos_q = positions if positions.ndim > 1 else positions[None, :]
        o = gqa_attention(q, k_all, v_all, pos_q=pos_q, pos_k=pos_k,
                          causal=True, window=window, prefix_len=prefix_len,
                          attn_cap=cfg.attn_softcap)
    out = dense(p["wo"], o.reshape(B, T, H * Dh))
    return out, new_kv


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_mlp(cfg: ArchConfig, d_ff=None, *, device, generator):
    """mlp styles: swiglu/geglu (gated, 3 matrices) or gelu (plain, 2)."""
    dt = _dtype(cfg)
    D = cfg.d_model
    Fd = d_ff or cfg.d_ff
    kw = dict(dtype=dt, device=device, generator=generator)
    p = {
        "w_up": _init_dense(D, Fd, **kw),
        "w_down": _init_dense(Fd, D, scale=1.0 / math.sqrt(Fd), **kw),
    }
    if cfg.mlp != "gelu":
        p["w_gate"] = _init_dense(D, Fd, **kw)
    return p


def _gelu_tanh(z):
    return F.gelu(z, approximate="tanh")


def apply_mlp(p, cfg: ArchConfig, x):
    if cfg.mlp == "gelu":
        return dense(p["w_down"], _gelu_tanh(dense(p["w_up"], x)))
    act = F.silu if cfg.mlp == "swiglu" else _gelu_tanh
    return dense(p["w_down"], act(dense(p["w_gate"], x)) * dense(p["w_up"], x))
