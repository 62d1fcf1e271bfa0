"""Model building blocks (port of ``repro/models/layers.py``).

Plain functions on tensors: parameters are nested dicts of tensors, and
every layer is an (init, apply) pair.  Conventions kept from the
reference so the parity tests compare like with like:

  * ``dense`` is ``x @ w`` with ``w`` as [d_in, d_out];
  * ``rms_norm`` has no ``1 +`` offset on the scale;
  * rope is half-split (not interleaved);
  * softmax and normalisers run in f32, activations in the param dtype;
  * attention is GQA-grouped (KV heads are never replicated in memory).

Ported: the attention core, unchunked, with checkpointed query blocks
(``chunk_q``, training lengths) and with the online softmax over key
chunks (``chunk``, which no model path calls), the prefix-LM mask, the
paged KV primitives and the contiguous cache write (``_cache_update``),
GQA attention with rope, sinusoidal (``sinusoidal_pos``, added to the
embeddings) or no positional encoding, MLA (multi-head latent attention
with the absorbed-weight decode, slice 3), the gated MLPs and MoE
(sort-based capacity dispatch, slice 3).

The training forward runs under autograd and writes nothing in place.  The
cache primitives update the cache IN PLACE (``paged_scatter``,
``_cache_update``, ``copy_block``) and return it: the caches are the
largest tensors of a serve run, nothing needs the pre-write value, and
serving runs under ``torch.inference_mode``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig
from repro_torch.kernels.paged_attention.ops import (paged_attention,
                                                     paged_mla_attention)

from . import act_sharding as ACT

QUERY_CHUNK_THRESHOLD = 2_048    # training: checkpointed query blocks
QUERY_CHUNK = 512


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


def _normal_stack(shape, std, *, dtype, device, generator):
    """``_normal`` for an expert stack [E, ...], drawn one expert at a
    time: at full width a [256, 7168, 2048] stack drawn whole would need
    two 15 GB f32 temporaries beside its 7.5 GB of bf16."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    out = torch.empty(shape, dtype=dtype, device=device)
    for e in range(shape[0]):
        out[e] = _normal(shape[1:], std, dtype=dtype, device=device,
                         generator=generator)
    return out


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


_ROPE_FREQS = {}


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """[head_dim / 2] f32 inverse frequencies ``1 / theta^(2i / head_dim)``,
    computed once per (head_dim, theta, device) on the host and kept: the
    decode step calls this twice per layer, and building the tensor there
    would be a blocking host-to-device copy each time.  The power is taken
    in f64 and rounded to f32, then inverted in f32, which is what the
    reference's ``theta ** exps`` gives on the CPU, bit for bit."""
    dev = torch.device("cpu" if device is None else device)
    key = (head_dim, float(theta), dev)
    inv = _ROPE_FREQS.get(key)
    if inv is None:
        exps = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
        base = torch.tensor(theta, dtype=torch.float32).double()
        power = torch.pow(base, exps.double()).float()
        with torch.inference_mode(False):   # usable outside serving too
            inv = _ROPE_FREQS[key] = (1.0 / power).to(dev)
    return inv


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


def sinusoidal_pos(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """[..., d_model] f32 table for integer ``positions`` [...]: the sines
    of ``pos * 10000^(-i / half)`` then their cosines, computed in f32 as
    the reference computes them."""
    half = d_model // 2
    freq = torch.exp(-math.log(10_000.0)
                     * torch.arange(half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


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


def _query_block(lo, hi, q_blk, pq_blk, k_full, v_full, pk_full, *,
                 causal, window, prefix_len, attn_cap):
    """One query block of the blocked attention: keys [lo, hi) only.  The
    slicing happens inside, so a checkpoint saves the full k/v once."""
    k_j, v_j = k_full[:, lo:hi], v_full[:, lo:hi]
    pk_j = pk_full[:, lo:hi]
    s = torch.einsum("bqhgd,bkhd->bhgqk", q_blk, k_j).float()
    s = softcap(s, attn_cap)
    s = s + _mask_bias(pq_blk, pk_j, causal=causal, window=window,
                       prefix_len=prefix_len)[:, None, None]
    s = torch.where(s == float("-inf"), -1e30, s)  # padded rows stay finite
    p = torch.softmax(s, dim=-1).to(v_j.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", p, v_j)


def gqa_attention(q, k, v, *, pos_q, pos_k, causal=True, window=None,
                  prefix_len=None, attn_cap=None, scale=None,
                  chunk=None, chunk_q=None) -> torch.Tensor:
    """q: [B,Tq,Hq,Dk]  k: [B,Tk,Hkv,Dk]  v: [B,Tk,Hkv,Dv] → [B,Tq,Hq,Dv].

    ``chunk_q``: blocked attention for TRAINING lengths: query blocks of
    ``chunk_q`` rows, each reading only the keys its causal diagonal and
    window reach (static extents; assumes arange-aligned positions from
    0), checkpointed while gradients flow so the backward recomputes one
    block's scores at a time.  ``chunk``: an online softmax over key
    chunks of ``chunk`` keys (a memory-lean forward; no model path calls
    it): Tk is padded to whole chunks with zero keys at a far position,
    which the causal mask hides (without ``causal`` they would enter the
    softmax, as in the reference).  Without either, scores for every
    (query, key) pair at once.
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

    if chunk_q is not None and Tq > chunk_q:
        C = chunk_q
        nq = -(-Tq // C)
        pad = nq * C - Tq
        if pad:
            qg = F.pad(qg, (0, 0, 0, 0, 0, 0, 0, pad))
            pos_q = F.pad(pos_q, (0, pad), value=-1)  # masked (pk<=pq fails)
        Tk = k.shape[1]
        kw = dict(causal=causal, window=window, prefix_len=prefix_len,
                  attn_cap=attn_cap)
        remat = torch.is_grad_enabled() and any(
            t.requires_grad for t in (qg, k, v))
        pre_hi = (-(-prefix_len // C) * C) if prefix_len else 0
        outs = []
        for j in range(nq):
            hi = Tk if not causal else min(Tk, max((j + 1) * C, pre_hi))
            lo = 0 if window is None else max(0, (j * C - window) // C * C)
            args = (lo, hi, qg[:, j * C:(j + 1) * C],
                    pos_q[:, j * C:(j + 1) * C], k, v, pos_k)
            if remat:
                outs.append(checkpoint(_query_block, *args, **kw,
                                       use_reentrant=False))
            else:
                outs.append(_query_block(*args, **kw))
        o = torch.cat(outs, dim=1).reshape(B, nq * C, Hq, Dv)
        return o[:, :Tq]

    if chunk is not None and k.shape[1] > chunk:
        return _online_softmax(qg, k, v, pos_q, pos_k, chunk, causal=causal,
                               window=window, prefix_len=prefix_len,
                               attn_cap=attn_cap).to(q.dtype)

    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float()
    s = softcap(s, attn_cap)
    s = s + _mask_bias(pos_q, pos_k, causal=causal, window=window,
                       prefix_len=prefix_len)[:, None, None]
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v)
    return o.reshape(B, Tq, Hq, Dv)


def _online_softmax(qg, k, v, pos_q, pos_k, chunk, *, causal, window,
                    prefix_len, attn_cap):
    """Attention of the grouped queries ``qg`` [B,Tq,Hkv,G,Dk] over key
    chunks of ``chunk``: a running max ``m``, normaliser ``l`` and f32
    accumulator, each chunk's scores rescaled by ``e^(m - m_new)``.
    Returns [B,Tq,Hkv*G,Dv] f32."""
    B, Tq, Hkv, G, _ = qg.shape
    Tk, Dv = k.shape[1], v.shape[-1]
    n_chunks = -(-Tk // chunk)
    pad = n_chunks * chunk - Tk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        pos_k = F.pad(pos_k, (0, pad), value=(2 ** 31 - 1) // 2)
    dev = qg.device
    m = torch.full((B, Hkv, G, Tq), float("-inf"), device=dev)
    l = torch.zeros((B, Hkv, G, Tq), device=dev)
    acc = torch.zeros((B, Hkv, G, Tq, Dv), device=dev)
    for j in range(n_chunks):
        sl = slice(j * chunk, (j + 1) * chunk)
        k_j, v_j = k[:, sl], v[:, sl]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_j).float()
        s = softcap(s, attn_cap)
        s = s + _mask_bias(pos_q, pos_k[:, sl], causal=causal, window=window,
                           prefix_len=prefix_len)[:, None, None]
        m_new = torch.maximum(m, s.amax(dim=-1))
        # a row that has seen no key keeps m_new == -inf: a finite proxy
        # keeps exp() from seeing (-inf) - (-inf)
        m_safe = torch.where(torch.isfinite(m_new), m_new,
                             torch.zeros((), device=dev))
        corr = torch.exp(m - m_safe)
        p = torch.exp(s - m_safe[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(v.dtype), v_j).float()
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.movedim(-2, 1).reshape(B, Tq, Hkv * G, Dv)


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


def _cache_update(buf, new, offset):
    """Write ``new`` [B,T,...] into the contiguous cache ``buf`` [B,S,...]
    at ``offset``, IN PLACE; returns ``buf``.

    * T == S: the write replaces the whole cache;
    * T == 1 (decode): ``offset`` is a scalar or a per-row [B] tensor (the
      serve engine's slots sit at independent lengths); row b writes
      position ``offset[b]``, and an offset outside [0, S) writes nothing
      (the reference's one-hot select over S matches no position);
    * general T (chunked prefill): a scalar offset, clamped as
      ``dynamic_update_slice`` clamps its start into [0, S - T].
    """
    S = buf.shape[1]
    T = new.shape[1]
    new = new.to(buf.dtype)
    if T == S:
        buf.copy_(new)
        return buf
    if T == 1:
        off = torch.as_tensor(offset, device=buf.device)
        if off.ndim == 0:
            off = off.reshape(1).expand(buf.shape[0])
        hit = torch.arange(S, device=buf.device)[None, :] == off[:, None]
        hit = hit.reshape(hit.shape + (1,) * (buf.ndim - 2))
        torch.where(hit, new, buf, out=buf)
        return buf
    if torch.as_tensor(offset).ndim != 0:
        raise ValueError("multi-token cache writes need a scalar offset")
    start = min(max(int(offset), 0), S - T)
    buf[:, start:start + T] = new
    return buf


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

    ``kv_cache`` is the contiguous cache {"k", "v"} [B, S, Hkv, Dh] when
    ``block_tables`` is None (decode attends over the whole row; the
    reference runs it outside any kernel, and so does the port), else
    paged pools [N, bs, Hkv, Dh] that the [B, n] ``block_tables`` map
    virtual positions onto.  Either is written in place.
    ``cache_offset`` is a scalar or per-row [B] count of tokens already
    cached.  In paged mode ``paged_kernel="auto"`` (the default) routes
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
    if cfg.pos_embed == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    # "sinusoidal": the embeddings carry the positions (transformer._embed)

    if kv_cache is None:
        chunk_q = QUERY_CHUNK if T >= QUERY_CHUNK_THRESHOLD else None
        o = gqa_attention(q, k, v, pos_q=positions, pos_k=positions,
                          causal=True, window=window, prefix_len=prefix_len,
                          attn_cap=cfg.attn_softcap, chunk_q=chunk_q)
        new_kv = {"k": k, "v": v}
    else:
        if block_tables is None:
            k_all = _cache_update(kv_cache["k"], k, cache_offset)
            v_all = _cache_update(kv_cache["v"], v, cache_offset)
            new_kv = {"k": k_all, "v": v_all}
        else:
            k_pool = paged_scatter(kv_cache["k"], k, block_tables,
                                   cache_offset)
            v_pool = paged_scatter(kv_cache["v"], v, block_tables,
                                   cache_offset)
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
        # a whole-prompt prefill at or past the threshold blocks its
        # queries, as the reference's (positions from 0)
        chunk_q = QUERY_CHUNK * 2 if T >= QUERY_CHUNK_THRESHOLD else None
        o = gqa_attention(q, k_all, v_all, pos_q=pos_q, pos_k=pos_k,
                          causal=True, window=window, prefix_len=prefix_len,
                          attn_cap=cfg.attn_softcap, chunk_q=chunk_q)
    out = dense(p["wo"], o.reshape(B, T, H * Dh))
    return out, new_kv


# ---------------------------------------------------------------------------
# MLA: multi-head latent attention (DeepSeek-V3)
# ---------------------------------------------------------------------------


def init_mla(cfg: ArchConfig, *, device, generator):
    m: MLAConfig = cfg.mla
    dt = _dtype(cfg)
    D, H = cfg.d_model, cfg.num_heads
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    kw = dict(dtype=dt, device=device, generator=generator)
    return {
        "q_down": _init_dense(D, m.q_lora_rank, **kw),
        "q_norm": init_rmsnorm(m.q_lora_rank, dtype=dt, device=device),
        "q_up": _init_dense(m.q_lora_rank, H * qk_dim, **kw),
        "kv_down": _init_dense(D, m.kv_lora_rank + m.qk_rope_head_dim, **kw),
        "kv_norm": init_rmsnorm(m.kv_lora_rank, dtype=dt, device=device),
        "kv_up": _init_dense(m.kv_lora_rank,
                             H * (m.qk_nope_head_dim + m.v_head_dim), **kw),
        "wo": _init_dense(H * m.v_head_dim, D, **kw),
    }


def _absorbed_weights(p, m: MLAConfig, H: int):
    """``kv_up`` split per head into W_uk [r,H,dn] and W_uv [r,H,dv]
    (strided views)."""
    dn, dv = m.qk_nope_head_dim, m.v_head_dim
    w_up = p["kv_up"]["w"].reshape(m.kv_lora_rank, H, dn + dv)
    return w_up[..., :dn], w_up[..., dn:]


def apply_mla(p, cfg: ArchConfig, x, *, positions, kv_cache=None,
              cache_offset=None, block_tables=None, paged_kernel="auto"):
    """Latent-cache MLA.  x: [B,T,D] → (out [B,T,D], new_cache).

    Without a cache: the whole-sequence forward.  With one, ``kv_cache``
    is the contiguous latent cache ``{"c_kv": [B,S,r], "k_rope":
    [B,S,1,dr]}`` when ``block_tables`` is None, else pools ``{"c_kv":
    [N,bs,r], "k_rope": [N,bs,1,dr]}`` addressed by ``block_tables``;
    either is written in place.  Prefill (T>1) expands the latents
    through ``kv_up`` into per-head K and V.  Decode (T==1) stays in
    latent space (weight absorption): over the contiguous cache it runs
    ``_mla_absorbed_decode`` (no kernel, as in the reference); in paged
    mode ``paged_kernel="auto"`` (the default) routes it through
    ``kernels.paged_attention.paged_mla_attention`` (the CUDA kernel on a
    CUDA pool, its plain version on a CPU pool) and ``"ref"`` gathers,
    then runs ``_mla_absorbed_decode``, as the reference's "ref"
    lowering."""
    m: MLAConfig = cfg.mla
    B, T, D = x.shape
    H = cfg.num_heads
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim

    q = dense(p["q_up"], rms_norm(p["q_norm"], dense(p["q_down"], x),
                                  cfg.norm_eps)).reshape(B, T, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    kv = dense(p["kv_down"], x)
    c_kv = rms_norm(p["kv_norm"], kv[..., :m.kv_lora_rank], cfg.norm_eps)
    k_rope = apply_rope(kv[..., None, m.kv_lora_rank:], positions,
                        cfg.rope_theta)                       # [B,T,1,dr]

    if kv_cache is not None and block_tables is None:
        c_kv = _cache_update(kv_cache["c_kv"], c_kv, cache_offset)
        k_rope = _cache_update(kv_cache["k_rope"], k_rope, cache_offset)
        new_cache = {"c_kv": c_kv, "k_rope": k_rope}
        S = c_kv.shape[1]
        pos_k = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
        pos_q = positions if positions.ndim > 1 else positions[None, :]
    elif kv_cache is not None:
        if paged_kernel not in ("auto", "ref"):
            raise ValueError(f"unknown paged_kernel {paged_kernel!r}")
        ckv_pool = paged_scatter(kv_cache["c_kv"], c_kv, block_tables,
                                 cache_offset)
        kr_pool = paged_scatter(kv_cache["k_rope"], k_rope, block_tables,
                                cache_offset)
        new_cache = {"c_kv": ckv_pool, "k_rope": kr_pool}
        if T == 1 and paged_kernel == "auto":
            # absorbed decode straight off the pools: the gather and the
            # [B,S] latent view never exist
            w_k, w_v = _absorbed_weights(p, m, H)
            q_eff = torch.einsum("bthd,rhd->bthr", q_nope, w_k)
            o_lat = paged_mla_attention(
                q_eff, q_rope, ckv_pool, kr_pool, block_tables,
                cache_offset, scale=1.0 / math.sqrt(dn + dr))
            o = torch.einsum("bthr,rhd->bthd", o_lat, w_v)
            out = dense(p["wo"], o.reshape(B, T, H * dv))
            return out, new_cache
        c_kv = paged_gather(ckv_pool, block_tables)
        k_rope = paged_gather(kr_pool, block_tables)
        S = c_kv.shape[1]
        pos_k = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
        pos_q = positions if positions.ndim > 1 else positions[None, :]
    else:
        S = T
        pos_k = positions
        pos_q = positions
        new_cache = {"c_kv": c_kv, "k_rope": k_rope}

    if kv_cache is not None and T == 1:
        o = _mla_absorbed_decode(p, cfg, q_nope, q_rope, c_kv, k_rope,
                                 cache_offset)
        out = dense(p["wo"], o.reshape(B, T, H * dv))
        return out, new_cache

    up = dense(p["kv_up"], c_kv).reshape(B, S, H, dn + dv)
    k_nope, v = up[..., :dn], up[..., dn:]
    k = torch.cat([k_nope, k_rope.expand(B, S, H, dr)], dim=-1)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    # training lengths block the queries, and so does a whole-prompt
    # prefill past the threshold, in twice the blocks (the reference's);
    # offset prefill stays below it (``prefill_chunk`` refuses longer
    # chunks)
    chunk_q = None
    if T >= QUERY_CHUNK_THRESHOLD:
        chunk_q = QUERY_CHUNK if kv_cache is None else QUERY_CHUNK * 2
    o = gqa_attention(qf, k, v, pos_q=pos_q, pos_k=pos_k, causal=True,
                      attn_cap=None, scale=1.0 / math.sqrt(dn + dr),
                      chunk_q=chunk_q)
    out = dense(p["wo"], o.reshape(B, T, H * dv))
    return out, new_cache


def _mla_absorbed_decode(p, cfg: ArchConfig, q_nope, q_rope, c_kv, k_rope,
                         offset):
    """One-token MLA attention in latent space (weight absorption):

      scores = (q_nope·W_uk)·c_kv + q_rope·k_rope     [B,H,1,S]
      out    = (softmax·c_kv)·W_uv                    [B,1,H,dv]

    Positions ``<= offset`` (scalar or per-row [B]) are valid; the rest
    score -1e30.  The scores pass the reference's ``scores_sshard``
    hook."""
    m = cfg.mla
    B, T, H, dn = q_nope.shape
    S = c_kv.shape[1]
    w_k, w_v = _absorbed_weights(p, m, H)

    q_eff = torch.einsum("bthd,rhd->bthr", q_nope, w_k)       # [B,1,H,r]
    s = torch.einsum("bthr,bsr->bhts", q_eff, c_kv).float()
    s = s + torch.einsum("bthd,bsd->bhts", q_rope,
                         k_rope[:, :, 0]).float()
    s = s / math.sqrt(dn + m.qk_rope_head_dim)
    s = ACT.scores_sshard(s)
    off = torch.as_tensor(offset, device=s.device).reshape(-1, 1, 1, 1)
    valid = torch.arange(S, dtype=torch.int32,
                         device=s.device)[None, None, None, :] <= off
    s = torch.where(valid, s, -1e30)
    prob = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhts,bsr->bthr", prob.to(c_kv.dtype), c_kv)
    return torch.einsum("bthr,rhd->bthd", o_lat, w_v)         # [B,1,H,dv]


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


# ---------------------------------------------------------------------------
# Mixture of Experts (sort-based capacity dispatch)
# ---------------------------------------------------------------------------


def init_moe(cfg: ArchConfig, *, device, generator):
    mo: MoEConfig = cfg.moe
    dt = _dtype(cfg)
    D, E, Fd = cfg.d_model, mo.num_experts, mo.d_expert
    kw = dict(dtype=dt, device=device, generator=generator)
    scale_in = 1.0 / math.sqrt(D)
    scale_out = 1.0 / math.sqrt(Fd)
    p = {
        "router": _init_dense(D, E, dtype=torch.float32, device=device,
                              generator=generator),
        "w_gate": _normal_stack((E, D, Fd), scale_in, **kw),
        "w_up": _normal_stack((E, D, Fd), scale_in, **kw),
        "w_down": _normal_stack((E, Fd, D), scale_out, **kw),
    }
    if mo.num_shared:
        p["shared"] = init_mlp(cfg, d_ff=Fd * mo.num_shared, device=device,
                               generator=generator)
    return p


def _router_gates(p, mo: MoEConfig, x2d):
    """Routing in f32: sigmoid (DeepSeek-V3) or softmax scores, top-k,
    then (``norm_topk``) gates renormalised over the k picks."""
    logits = x2d.float() @ p["router"]["w"].float()
    if mo.router == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(scores, mo.top_k, dim=-1)          # [T,k]
    if mo.norm_topk:
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, idx, scores


def moe_load_balance_loss(scores, idx, num_experts):
    """Switch-style load-balance aux loss (mean prob × token fraction)."""
    frac_prob = scores.mean(0)
    counts = torch.zeros((num_experts,), dtype=torch.float32,
                         device=scores.device)
    counts = counts.index_add(0, idx.reshape(-1),
                              torch.ones(idx.numel(), dtype=torch.float32,
                                         device=scores.device))
    frac_tok = counts / torch.clamp(counts.sum(), min=1.0)
    return num_experts * torch.sum(frac_prob * frac_tok)


def apply_moe(p, cfg: ArchConfig, x):
    """x: [B,T,D] → (y, aux_loss).  Group-wise sort-based capacity
    dispatch, as the reference: the group is the batch row, with local
    capacity C = ceil(T·k/E·cf).  Per row:

      1. top-k routing → (token, expert, gate) triples in (t, k) order;
      2. a stable sort by expert; position-in-expert by segment offsets;
      3. a [B,E,C,D] buffer gathered through an [E,C] slot→token map
         (row T of the padded input reads zeros); batched expert GEMMs
         over every expert;
      4. the gate-weighted scatter-add back; tokens past an expert's
         capacity drop (GShard).  Then the shared expert.

    The backward (training, slice 11) is autograd's through these ops:
    the gates' gradients follow ``torch.topk``'s values, a dropped pick
    (weight 0) gives its expert nothing, and an expert no token reaches
    computes on zero rows, so its weights get zero gradients, as JAX's.
    The expert buffers pass the reference's ``moe_buf`` hook.  On CUDA the combine's ``index_add_`` uses atomics, so its
    bf16 sums may round differently from run to run."""
    mo: MoEConfig = cfg.moe
    B, T, D = x.shape
    E, K = mo.num_experts, mo.top_k
    C = max(1, int(math.ceil(T * K / E * mo.capacity_factor)))
    dev = x.device

    gates, idx, scores = _router_gates(p, mo, x.reshape(B * T, D))
    flat_e = idx.reshape(B, T * K)                            # (t, k) order
    flat_g = gates.reshape(B, T * K)
    flat_t = torch.arange(T, device=dev).repeat_interleave(K)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    e_s = torch.gather(flat_e, 1, order)                      # [B, T*K]
    g_s = torch.gather(flat_g, 1, order)
    t_s = flat_t[order]
    starts = torch.searchsorted(
        e_s, torch.arange(E, device=dev).expand(B, E).contiguous())
    pos = torch.arange(T * K, device=dev) - torch.gather(starts, 1, e_s)
    keep = pos < C
    slot = torch.where(keep, pos, C)                          # C: overflow
    rows = torch.arange(B, device=dev)[:, None]
    slot_tok = torch.full((B, E, C + 1), T, dtype=torch.int64, device=dev)
    slot_tok[rows, e_s, slot] = torch.where(keep, t_s, T)
    slot_tok = slot_tok[:, :, :C]                             # [B,E,C]
    w = g_s * keep.float()

    x_pad = torch.cat([x, x.new_zeros((B, 1, D))], dim=1)     # [B,T+1,D]
    buf = x_pad[rows, slot_tok.reshape(B, E * C)].reshape(B, E, C, D)
    buf = ACT.moe_buf(buf)

    act = F.silu if cfg.mlp == "swiglu" else _gelu_tanh
    h = act(torch.einsum("becd,edf->becf", buf, p["w_gate"])) \
        * torch.einsum("becd,edf->becf", buf, p["w_up"])
    y_exp = ACT.moe_buf(
        torch.einsum("becf,efd->becd", h, p["w_down"]))       # [B,E,C,D]

    contrib = y_exp[rows, e_s, torch.clamp(slot, max=C - 1)] \
        * w.to(y_exp.dtype)[..., None]                        # [B,T*K,D]
    y = torch.zeros((B * T, D), dtype=y_exp.dtype, device=dev)
    y.index_add_(0, (rows * T + t_s).reshape(-1),
                 contrib.reshape(B * T * K, D))
    y = y.reshape(B, T, D)

    if mo.num_shared:
        y = y + apply_mlp(p["shared"], cfg, x.reshape(B * T, D)
                          ).reshape(B, T, D)
    aux = moe_load_balance_loss(scores, idx.reshape(B * T, K), E)
    return y, aux
