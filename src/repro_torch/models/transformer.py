"""LM assembler (port of ``repro/models/transformer.py``).

The reference stacks each segment's layers and scans them; the port keeps
one parameter dict per layer (``params["layers"][i]``, in layer order) and
loops over them in Python — eager PyTorch has no trace to keep small.
``weights.from_jax_params`` maps the reference's stacked tree onto this
layout.

API (slice 1: paged serving of dense GQA models):

  init_params(cfg, seed=0, device=...)          -> params
  init_paged_cache(cfg, num_blocks, block_size) -> per-layer pools
  decode_step(params, cfg, token, cache, offset, block_tables, ...)
                                                -> (logits, cache)
  prefill_chunk(params, cfg, tokens, cache, offset, ...)
                                                -> (logits | None, cache)
  copy_block(cache, src, dst)                   -> cache (copy-on-write)

Cache pools are written in place and returned.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from . import layers as L

ATTN_KINDS = ("attn", "attn_moe", "local", "global")
MLA_KINDS = ("mla", "mla_moe")
MAMBA_KINDS = ("mamba", "mamba_moe")
XLSTM_KINDS = ("mlstm", "slstm")
REC_KINDS = MAMBA_KINDS + XLSTM_KINDS

# layer kinds the port can build and run today
PORTED_KINDS = ("attn", "local", "global")


def _check_ported(cfg: ArchConfig) -> None:
    for kind in cfg.layer_pattern:
        if kind not in PORTED_KINDS:
            raise NotImplementedError(
                f"{cfg.name}: layer kind {kind!r} is not ported yet (port "
                "slice 3: MLA, MoE and recurrent layers)")
    if cfg.frontend or cfg.prefix_lm or cfg.mtp_depth:
        raise NotImplementedError(
            f"{cfg.name}: frontends, prefix-LM and MTP come with port "
            "slice 3")


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def init_block(cfg: ArchConfig, kind: str, *, device, generator):
    dt = L._dtype(cfg)
    p: Dict[str, Any] = {
        "norm1": L.init_rmsnorm(cfg.d_model, dtype=dt, device=device),
        "attn": L.init_attention(cfg, device=device, generator=generator),
        "norm2": L.init_rmsnorm(cfg.d_model, dtype=dt, device=device),
    }
    if cfg.norm_style == "sandwich":
        p["post1"] = L.init_rmsnorm(cfg.d_model, dtype=dt, device=device)
        p["post2"] = L.init_rmsnorm(cfg.d_model, dtype=dt, device=device)
    p["ffn"] = L.init_mlp(cfg, device=device, generator=generator)
    return p


def apply_block(p, cfg: ArchConfig, kind: str, h, *, positions,
                cache=None, offset=None, prefix_len=None, block_tables=None,
                paged_kernel="auto"):
    """Returns (h, new_cache)."""
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"layer kind {kind!r} is not ported yet (port slice 3)")
    sandwich = cfg.norm_style == "sandwich"
    x = L.rms_norm(p["norm1"], h, cfg.norm_eps)
    window = cfg.sliding_window if kind == "local" else None
    mix, new_cache = L.apply_attention(
        p["attn"], cfg, x, positions=positions, kv_cache=cache,
        cache_offset=offset, window=window, prefix_len=prefix_len,
        block_tables=block_tables, paged_kernel=paged_kernel)
    if sandwich:
        mix = L.rms_norm(p["post1"], mix, cfg.norm_eps)
    h = h + mix
    x = L.rms_norm(p["norm2"], h, cfg.norm_eps)
    y = L.apply_mlp(p["ffn"], cfg, x)
    if sandwich:
        y = L.rms_norm(p["post2"], y, cfg.norm_eps)
    return h + y, new_cache


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def init_paged_cache(cfg: ArchConfig, num_blocks: int, block_size: int, *,
                     device="cuda") -> List[Dict[str, torch.Tensor]]:
    """Pooled paged cache, one {"k", "v"} pair per layer, each
    [num_blocks, block_size, Hkv, Dh] (axis 0 = PHYSICAL BLOCK).  Zeroed,
    as the reference's ``jnp.zeros``: a masked slot must never hold NaN."""
    _check_ported(cfg)
    dev = resolve_device(device)
    dt = L._dtype(cfg)
    shape = (num_blocks, block_size, cfg.num_kv_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=dt, device=dev),
             "v": torch.zeros(shape, dtype=dt, device=dev)}
            for _ in cfg.layer_pattern]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def init_params(cfg: ArchConfig, seed: int = 0, *, device="cuda"
                ) -> Dict[str, Any]:
    """Random-init parameters with the reference's scales, drawn from a
    ``torch.Generator`` on ``device`` (``"meta"`` gives shapes only).  The
    values differ from the reference's (another generator); parity tests
    load the reference's params through ``weights.from_jax_params``."""
    _check_ported(cfg)
    if torch.device(device).type == "meta":
        dev, gen = torch.device("meta"), None
    else:
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    dt = L._dtype(cfg)
    V, D = cfg.vocab_size, cfg.d_model
    params: Dict[str, Any] = {
        "embed": L._normal((V, D), 0.02, dtype=dt, device=dev,
                           generator=gen),
        "final_norm": L.init_rmsnorm(D, dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = L._init_dense(D, V, scale=1.0 / math.sqrt(D),
                                       dtype=dt, device=dev, generator=gen)
    params["layers"] = [init_block(cfg, kind, device=dev, generator=gen)
                        for kind in cfg.layer_pattern]
    return params


# ---------------------------------------------------------------------------
# forward pieces
# ---------------------------------------------------------------------------


def _embed(params, cfg: ArchConfig, tokens):
    h = params["embed"][tokens]
    if cfg.embed_scale:
        h = h * math.sqrt(cfg.d_model)
    return h


def _run_segments(params, cfg: ArchConfig, h, *, positions, caches=None,
                  offset=None, prefix_len=None, block_tables=None,
                  paged_kernel="auto"):
    """Run every layer in order (the reference scans stacked segments)."""
    new_caches = []
    for i, kind in enumerate(cfg.layer_pattern):
        c = None if caches is None else caches[i]
        h, nc = apply_block(params["layers"][i], cfg, kind, h,
                            positions=positions, cache=c, offset=offset,
                            prefix_len=prefix_len, block_tables=block_tables,
                            paged_kernel=paged_kernel)
        new_caches.append(nc)
    return h, (None if caches is None else new_caches)


def _head(params, cfg: ArchConfig, h):
    w = params["embed"].T if cfg.tie_embeddings else params["head"]["w"]
    logits = (h @ w).float()
    return L.softcap(logits, cfg.logit_softcap)


# ---------------------------------------------------------------------------
# inference: chunked prefill + decode over the paged cache
# ---------------------------------------------------------------------------


def decode_step(params, cfg: ArchConfig, token, cache, offset,
                block_tables=None, paged_kernel="auto"):
    """token: [B,1] ints; offset: tokens already cached — a scalar or a
    per-row [B] tensor.  ``block_tables`` [B, n] addresses the paged pools
    (written in place).  ``paged_kernel="auto"`` (the default) routes
    attention through ``kernels.paged_attention`` (the CUDA kernel on a
    CUDA cache, its plain version on the CPU); ``"ref"`` gathers, then
    attends."""
    if block_tables is None:
        raise NotImplementedError(
            "decode over the contiguous KV cache is not ported yet")
    B = token.shape[0]
    dev = token.device
    off = torch.as_tensor(offset, dtype=torch.int32, device=dev)
    if off.ndim == 1:
        positions = off[:, None]
    else:
        positions = off.reshape(1, 1).expand(B, 1)
    h = _embed(params, cfg, token)
    h, new_caches = _run_segments(params, cfg, h, positions=positions,
                                  caches=cache, offset=off,
                                  block_tables=block_tables,
                                  paged_kernel=paged_kernel)
    h = L.rms_norm(params["final_norm"], h, cfg.norm_eps)
    return _head(params, cfg, h), new_caches


def prefill_chunk(params, cfg: ArchConfig, tokens, cache, offset,
                  with_logits: bool = True, block_tables=None):
    """Write a prompt chunk [B,T] at cache positions [offset, offset+T).

    Returns logits for the WHOLE chunk [B,T,V] (the engine picks the real
    last position) — or None with ``with_logits=False``, which skips the
    full-vocab head on interior chunks — and the updated cache."""
    if block_tables is None:
        raise NotImplementedError(
            "prefill into the contiguous KV cache is not ported yet")
    B, T = tokens.shape
    if T >= L.QUERY_CHUNK_THRESHOLD:
        raise ValueError(
            f"prefill chunk length {T} >= {L.QUERY_CHUNK_THRESHOLD}: "
            "offset prefill must stay below the blocked-attention "
            "threshold — use smaller chunks")
    dev = tokens.device
    off = int(offset)
    positions = (off + torch.arange(T, dtype=torch.int32, device=dev)
                 )[None, :].expand(B, T)
    h = _embed(params, cfg, tokens)
    h, new_caches = _run_segments(params, cfg, h, positions=positions,
                                  caches=cache, offset=off,
                                  block_tables=block_tables)
    if not with_logits:
        return None, new_caches
    h = L.rms_norm(params["final_norm"], h, cfg.norm_eps)
    return _head(params, cfg, h), new_caches


def copy_block(cache, src: int, dst: int):
    """Copy one physical block's payload in every paged-cache leaf, in
    place (the device half of copy-on-write)."""
    for layer in cache:
        for pool in layer.values():
            pool[dst].copy_(pool[src])
    return cache
