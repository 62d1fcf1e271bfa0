"""LM assembler (port of ``repro/models/transformer.py``).

The reference stacks each segment's layers and scans them; the port keeps
one parameter dict per layer (``params["layers"][i]``, in layer order) and
loops over them in Python — eager PyTorch has no trace to keep small.
``weights.from_jax_params`` maps the reference's stacked tree onto this
layout.

API (dense GQA models: slice 1 paged serving, slice 2 training; MLA and
MoE models, DeepSeek-V3: slice 3 paged serving):

  init_params(cfg, seed=0, device=...)          -> params
  forward(params, cfg, tokens)                  -> logits [B,T,V]
  loss_fn(params, cfg, batch)                   -> (loss, metrics)
  init_paged_cache(cfg, num_blocks, block_size) -> per-layer pools
  decode_step(params, cfg, token, cache, offset, block_tables, ...)
                                                -> (logits, cache)
  prefill_chunk(params, cfg, tokens, cache, offset, ...)
                                                -> (logits | None, cache)
  copy_block(cache, src, dst)                   -> cache (copy-on-write)

Cache pools are written in place and returned.  ``params["mtp"]`` (the
multi-token-prediction modules) is built and carried as the reference's,
but only the training loss reads it, and training MTP/MoE models is not
ported: ``loss_fn`` raises for them.  The loss is
sequence-chunked (logits for 512 tokens at a time, each chunk under
``torch.utils.checkpoint``), so a 256k-vocab train step never holds
[B,T,V] logits.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from . import layers as L

ATTN_KINDS = ("attn", "attn_moe", "local", "global")
MLA_KINDS = ("mla", "mla_moe")
MAMBA_KINDS = ("mamba", "mamba_moe")
XLSTM_KINDS = ("mlstm", "slstm")
MOE_KINDS = ("attn_moe", "mla_moe", "mamba_moe")
REC_KINDS = MAMBA_KINDS + XLSTM_KINDS

# layer kinds the port can build and run today
PORTED_KINDS = ("attn", "attn_moe", "local", "global", "mla", "mla_moe")

LOSS_CHUNK = 512


def _check_ported(cfg: ArchConfig, *, training: bool = False) -> None:
    for kind in cfg.layer_pattern:
        if kind not in PORTED_KINDS:
            raise NotImplementedError(
                f"{cfg.name}: layer kind {kind!r} is not ported yet "
                "(recurrent layers come with a later slice of the port)")
    if cfg.frontend or cfg.prefix_lm:
        raise NotImplementedError(
            f"{cfg.name}: frontends and prefix-LM are not ported yet")
    if training and (cfg.mtp_depth or cfg.moe is not None):
        raise NotImplementedError(
            f"{cfg.name}: training MTP and MoE models (the MTP loss, the "
            "0.01 * aux balance loss, the MoE backward) is not ported yet; "
            "the port serves them")


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def init_block(cfg: ArchConfig, kind: str, *, device, generator):
    if kind not in PORTED_KINDS:
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet")
    dt = L._dtype(cfg)
    mixer = L.init_mla if kind in MLA_KINDS else L.init_attention
    p: Dict[str, Any] = {
        "norm1": L.init_rmsnorm(cfg.d_model, dtype=dt, device=device),
        "attn": mixer(cfg, device=device, generator=generator),
        "norm2": L.init_rmsnorm(cfg.d_model, dtype=dt, device=device),
    }
    if cfg.norm_style == "sandwich":
        p["post1"] = L.init_rmsnorm(cfg.d_model, dtype=dt, device=device)
        p["post2"] = L.init_rmsnorm(cfg.d_model, dtype=dt, device=device)
    ffn = L.init_moe if kind in MOE_KINDS else L.init_mlp
    p["ffn"] = ffn(cfg, device=device, generator=generator)
    return p


def apply_block(p, cfg: ArchConfig, kind: str, h, *, positions,
                cache=None, offset=None, prefix_len=None, block_tables=None,
                paged_kernel="auto"):
    """Returns (h, new_cache, aux): aux is the MoE load-balance loss (an
    f32 zero for dense blocks)."""
    if kind not in PORTED_KINDS:
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet")
    sandwich = cfg.norm_style == "sandwich"
    x = L.rms_norm(p["norm1"], h, cfg.norm_eps)
    if kind in MLA_KINDS:
        mix, new_cache = L.apply_mla(
            p["attn"], cfg, x, positions=positions, kv_cache=cache,
            cache_offset=offset, block_tables=block_tables,
            paged_kernel=paged_kernel)
    else:
        window = cfg.sliding_window if kind == "local" else None
        mix, new_cache = L.apply_attention(
            p["attn"], cfg, x, positions=positions, kv_cache=cache,
            cache_offset=offset, window=window, prefix_len=prefix_len,
            block_tables=block_tables, paged_kernel=paged_kernel)
    if sandwich:
        mix = L.rms_norm(p["post1"], mix, cfg.norm_eps)
    h = h + mix
    x = L.rms_norm(p["norm2"], h, cfg.norm_eps)
    if kind in MOE_KINDS:
        y, aux = L.apply_moe(p["ffn"], cfg, x)
    else:
        y = L.apply_mlp(p["ffn"], cfg, x)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if sandwich:
        y = L.rms_norm(p["post2"], y, cfg.norm_eps)
    return h + y, new_cache, aux


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def init_paged_cache(cfg: ArchConfig, num_blocks: int, block_size: int, *,
                     device="cuda") -> List[Dict[str, torch.Tensor]]:
    """Pooled paged cache, one dict per layer (axis 0 = PHYSICAL BLOCK):
    attention layers {"k", "v"}, each [num_blocks, block_size, Hkv, Dh];
    MLA layers the latent pair {"c_kv": [num_blocks, block_size, r],
    "k_rope": [num_blocks, block_size, 1, dr]}.  Zeroed, as the
    reference's ``jnp.zeros``: a masked slot must never hold NaN."""
    _check_ported(cfg)
    dev = resolve_device(device)
    dt = L._dtype(cfg)
    z = lambda *shape: torch.zeros(shape, dtype=dt, device=dev)
    N, bs = num_blocks, block_size
    out = []
    for kind in cfg.layer_pattern:
        if kind in MLA_KINDS:
            m = cfg.mla
            out.append({"c_kv": z(N, bs, m.kv_lora_rank),
                        "k_rope": z(N, bs, 1, m.qk_rope_head_dim)})
        else:
            out.append({"k": z(N, bs, cfg.num_kv_heads, cfg.head_dim),
                        "v": z(N, bs, cfg.num_kv_heads, cfg.head_dim)})
    return out


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
    if cfg.mtp_depth:
        kind = "mla" if cfg.mla else "attn"
        params["mtp"] = [
            {"proj": L._init_dense(2 * D, D, dtype=dt, device=dev,
                                   generator=gen),
             "block": init_block(cfg, kind, device=dev, generator=gen),
             "norm": L.init_rmsnorm(D, dtype=dt, device=dev)}
            for _ in range(cfg.mtp_depth)]
    return params


# ---------------------------------------------------------------------------
# forward pieces
# ---------------------------------------------------------------------------


def _embed(params, cfg: ArchConfig, tokens):
    h = F.embedding(tokens, params["embed"])
    if cfg.embed_scale:
        h = h * math.sqrt(cfg.d_model)
    return h


def _run_segments(params, cfg: ArchConfig, h, *, positions, caches=None,
                  offset=None, prefix_len=None, block_tables=None,
                  paged_kernel="auto"):
    """Run every layer in order (the reference scans stacked segments).
    The blocks' MoE aux losses are dropped: only training reads them."""
    new_caches = []
    for i, kind in enumerate(cfg.layer_pattern):
        c = None if caches is None else caches[i]
        h, nc, _aux = apply_block(
            params["layers"][i], cfg, kind, h, positions=positions, cache=c,
            offset=offset, prefix_len=prefix_len, block_tables=block_tables,
            paged_kernel=paged_kernel)
        new_caches.append(nc)
    return h, (None if caches is None else new_caches)


def _head(params, cfg: ArchConfig, h):
    w = params["embed"].T if cfg.tie_embeddings else params["head"]["w"]
    logits = (h @ w).float()
    return L.softcap(logits, cfg.logit_softcap)


# ---------------------------------------------------------------------------
# training: full-sequence forward and the chunked loss
# ---------------------------------------------------------------------------


def forward(params, cfg: ArchConfig, tokens):
    """Full-sequence logits [B,T,V] f32 (small vocab / small T only —
    training uses ``loss_fn``, which chunks the head)."""
    _check_ported(cfg)
    T = tokens.shape[1]
    positions = torch.arange(T, dtype=torch.int32, device=tokens.device)
    h = _embed(params, cfg, tokens)
    h, _ = _run_segments(params, cfg, h, positions=positions)
    h = L.rms_norm(params["final_norm"], h, cfg.norm_eps)
    return _head(params, cfg, h)


def _chunked_xent(params, cfg: ArchConfig, h, labels, mask):
    """Sequence-chunked cross-entropy: logits never exceed [B,chunk,V];
    each chunk's logits are recomputed in the backward pass.  Chunk sums
    are added in sequence order, as the reference's scan adds them."""
    B, T, D = h.shape
    chunk = min(LOSS_CHUNK, T)
    n_chunks = -(-T // chunk)
    pad = n_chunks * chunk - T
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))

    def chunk_loss(h_j, l_j, m_j):
        logits = _head(params, cfg, h_j)                # [B,chunk,V] f32
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, l_j[..., None].long())[..., 0]
        nll = (lse - gold) * m_j
        return nll.sum(), m_j.sum()

    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    remat = torch.is_grad_enabled()
    for j in range(n_chunks):
        sl = slice(j * chunk, (j + 1) * chunk)
        args = (h[:, sl], labels[:, sl], mask[:, sl])
        s, c = (checkpoint(chunk_loss, *args, use_reentrant=False)
                if remat else chunk_loss(*args))
        tot, cnt = tot + s, cnt + c
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(params, cfg: ArchConfig, batch) -> Tuple[torch.Tensor, Dict]:
    """batch: {tokens [B,T], labels [B,T]} (integer tensors); labels < 0
    are masked.  Returns (loss, metrics) with metrics {"xent", "aux"}, as
    the reference's dense path (aux is the MoE balance loss: 0 here).
    Raises for MTP and MoE models, whose training is not ported yet."""
    _check_ported(cfg, training=True)
    tokens, labels = batch["tokens"], batch["labels"]
    T = tokens.shape[1]
    positions = torch.arange(T, dtype=torch.int32, device=tokens.device)
    h = _embed(params, cfg, tokens)
    h, _ = _run_segments(params, cfg, h, positions=positions)
    h = L.rms_norm(params["final_norm"], h, cfg.norm_eps)
    mask = (labels >= 0).float()
    loss = _chunked_xent(params, cfg, h, torch.clamp(labels, min=0), mask)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return loss, {"xent": loss, "aux": aux}


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
