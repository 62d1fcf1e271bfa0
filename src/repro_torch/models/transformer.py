"""LM assembler (port of ``repro/models/transformer.py``).

The reference stacks each segment's layers and scans them; the port keeps
one parameter dict per layer (``params["layers"][i]``, in layer order) and
loops over them in Python — eager PyTorch has no trace to keep small.
``weights.from_jax_params`` maps the reference's stacked tree onto this
layout.

API (dense GQA models: slice 1 paged serving, slice 2 training; MLA and
MoE models, DeepSeek-V3: slice 3 paged serving; the contiguous cache,
recurrent (mamba, mLSTM, sLSTM) and hybrid stacks: slice 10 serving;
training the MTP, MoE and recurrent models: slice 11; the frontend
models, trained and decoded at the model level: slice 12):

  init_params(cfg, seed=0, device=...)          -> params
  forward(params, cfg, tokens, frontend_embeds=None, positions=None)
                                                -> logits [B,Tf+T,V]
  loss_fn(params, cfg, batch)                   -> (loss, metrics)
  set_remat(mode)                               (the training remat policy)
  init_cache(cfg, batch, max_len)               -> per-layer caches
  init_paged_cache(cfg, num_blocks, block_size) -> per-layer pools
  init_hybrid_cache(cfg, kv_batch=, kv_len=, rec_batch=)
                                                -> per-layer caches
  prefill(params, cfg, tokens, cache, frontend_embeds=None)
                                                -> (last logits, cache,
                                                    Tf+T)
  decode_step(params, cfg, token, cache, offset, block_tables, ...)
                                                -> (logits, cache)
  prefill_chunk(params, cfg, tokens, cache, offset, ...)
                                                -> (logits | None, cache)
  take_slot / write_slot / reset_slot, take_state / write_state /
  reset_slot_state                              (the serve engine's
                                                 per-slot surgery)
  copy_block(cache, src, dst)                   -> cache (copy-on-write)

Caches are written in place and returned; a recurrent layer without
``rec_rows`` returns its new state as new tensors.  ``params["mtp"]``
(the multi-token-prediction modules) is read by the training loss only.
Training holds memory as the reference does: each scanned unit of
``cfg.segments()`` runs under ``torch.utils.checkpoint`` (``_REMAT =
"block"``), the recurrent scans keep only time-chunk boundary carries
(``ssm.TIME_CHUNK``), and the loss is sequence-chunked (logits for 512
tokens at a time, each chunk checkpointed), so a 256k-vocab train step
never holds [B,T,V] logits.

Frontend models (paligemma-3b, musicgen-medium) take ``Tf`` stub
embeddings [B, Tf, frontend_dim] (``batch["frontend"]`` in training),
projected by ``frontend_proj`` and put before the token embeddings; with
``cfg.prefix_lm`` the prefix attends bidirectionally.  The loss is taken
over the text positions only.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from . import act_sharding as ACT
from . import layers as L
from . import ssm as S

ATTN_KINDS = ("attn", "attn_moe", "local", "global")
MLA_KINDS = ("mla", "mla_moe")
MAMBA_KINDS = ("mamba", "mamba_moe")
XLSTM_KINDS = ("mlstm", "slstm")
MOE_KINDS = ("attn_moe", "mla_moe", "mamba_moe")
REC_KINDS = MAMBA_KINDS + XLSTM_KINDS

# layer kinds the port can build, serve and train
PORTED_KINDS = ATTN_KINDS + MLA_KINDS + MAMBA_KINDS + XLSTM_KINDS

LOSS_CHUNK = 512

# Rematerialisation policy for the training forward, as the reference's:
# "block" checkpoints each scanned unit of ``cfg.segments()`` (its
# activations are recomputed in the backward), "none" keeps everything.
# The reference's "dots" (save matmul outputs only) belongs to the dry run
# (ROADMAP A13).  A policy knob, not an architecture property.
_REMAT = "block"


def set_remat(mode: str) -> None:
    global _REMAT
    if mode == "dots":
        raise NotImplementedError(
            "set_remat('dots') (checkpoint_dots_with_no_batch_dims) belongs "
            "to the dry run, not ported yet (ROADMAP A13)")
    if mode not in ("none", "block"):
        raise ValueError(mode)
    _REMAT = mode


def _check_ported(cfg: ArchConfig) -> None:
    for kind in cfg.layer_pattern:
        if kind not in PORTED_KINDS:
            raise NotImplementedError(
                f"{cfg.name}: unknown layer kind {kind!r}")


def has_recurrent(cfg: ArchConfig) -> bool:
    """True if any layer carries O(1) recurrent state (mamba / xLSTM)."""
    return any(k in REC_KINDS for k in cfg.layer_pattern)


def has_attention(cfg: ArchConfig) -> bool:
    """True if any layer carries a positional KV cache (attention / MLA)."""
    return any(k in ATTN_KINDS or k in MLA_KINDS for k in cfg.layer_pattern)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def init_block(cfg: ArchConfig, kind: str, *, device, generator):
    if kind not in PORTED_KINDS:
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet")
    dt = L._dtype(cfg)
    if kind == "mlstm":
        return {"cell": S.init_mlstm(cfg, device=device,
                                     generator=generator)}
    if kind == "slstm":
        return {"cell": S.init_slstm(cfg, device=device,
                                     generator=generator)}
    p: Dict[str, Any] = {
        "norm1": L.init_rmsnorm(cfg.d_model, dtype=dt, device=device)}
    if kind in MAMBA_KINDS:
        p["mamba"] = S.init_mamba(cfg, device=device, generator=generator)
    else:
        mixer = L.init_mla if kind in MLA_KINDS else L.init_attention
        p["attn"] = mixer(cfg, device=device, generator=generator)
    p["norm2"] = L.init_rmsnorm(cfg.d_model, dtype=dt, device=device)
    if cfg.norm_style == "sandwich":
        p["post1"] = L.init_rmsnorm(cfg.d_model, dtype=dt, device=device)
        p["post2"] = L.init_rmsnorm(cfg.d_model, dtype=dt, device=device)
    ffn = L.init_moe if kind in MOE_KINDS else L.init_mlp
    p["ffn"] = ffn(cfg, device=device, generator=generator)
    return p


def _gather_rec(cache, rec_rows):
    """The pooled recurrent state at rows ``rec_rows`` [B] (a copy)."""
    return {k: x[rec_rows] for k, x in cache.items()}


def _scatter_rec(cache, new_state, rec_rows):
    """Write per-row state back into the pool, IN PLACE; returns the pool.
    Rows gated off by the update mask carry their own gathered value, so
    duplicate sentinel indices (row 0 for every masked batch row) all
    write identical bits."""
    for k, full in cache.items():
        full[rec_rows] = new_state[k].to(full.dtype)
    return cache


def _recurrent(fwd, p, cfg, h, cache, rec_rows, update_mask):
    """A recurrent mixer over the pooled rows ``rec_rows`` of ``cache``
    (gathered, advanced, scattered back), or over ``cache`` itself (one
    state row per batch row) when ``rec_rows`` is None."""
    state = cache
    if cache is not None and rec_rows is not None:
        state = _gather_rec(cache, rec_rows)
    out, new_state = fwd(p, cfg, h, state, update_mask=update_mask)
    if cache is not None and rec_rows is not None:
        new_state = _scatter_rec(cache, new_state, rec_rows)
    return out, new_state


def apply_block(p, cfg: ArchConfig, kind: str, h, *, positions,
                cache=None, offset=None, prefix_len=None, block_tables=None,
                paged_kernel="auto", rec_rows=None, update_mask=None):
    """Returns (h, new_cache, aux): aux is the MoE load-balance loss (an
    f32 zero for dense blocks).

    ``rec_rows`` [B] addresses pooled recurrent state (serve engine): the
    block gathers each batch row's state from the pool, advances it, and
    scatters it back.  ``update_mask`` [B,T] prefix-gates the advance per
    row (chunk padding, inactive decode slots); attention layers ignore
    it — their masked writes land on causally hidden positions instead."""
    if kind not in PORTED_KINDS:
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet")
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if kind in XLSTM_KINDS:
        fwd = S.mlstm_forward if kind == "mlstm" else S.slstm_forward
        h, new_cache = _recurrent(fwd, p["cell"], cfg, h, cache, rec_rows,
                                  update_mask)
        return h, new_cache, aux
    sandwich = cfg.norm_style == "sandwich"
    x = L.rms_norm(p["norm1"], h, cfg.norm_eps)
    if kind in MLA_KINDS:
        mix, new_cache = L.apply_mla(
            p["attn"], cfg, x, positions=positions, kv_cache=cache,
            cache_offset=offset, block_tables=block_tables,
            paged_kernel=paged_kernel)
    elif kind in MAMBA_KINDS:
        mix, new_cache = _recurrent(S.mamba_forward, p["mamba"], cfg, x,
                                    cache, rec_rows, update_mask)
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
    if sandwich:
        y = L.rms_norm(p["post2"], y, cfg.norm_eps)
    return h + y, new_cache, aux


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def _block_cache(cfg: ArchConfig, kind: str, batch: int, max_len: int, *,
                 device):
    """One layer's zeroed cache, as the reference's (``jnp.zeros``: a masked
    slot must never hold NaN).  KV leaves [batch, max_len, ...] (a paged
    pool is ``batch`` = blocks, ``max_len`` = block size); recurrent leaves
    [batch, ...] state rows, f32 but the conv window (the model dtype)."""
    dt = L._dtype(cfg)
    z = lambda *shape, dtype=dt: torch.zeros(shape, dtype=dtype,
                                             device=device)
    f32 = torch.float32
    if kind in ATTN_KINDS:
        hkv, dh = cfg.num_kv_heads, cfg.head_dim
        return {"k": z(batch, max_len, hkv, dh),
                "v": z(batch, max_len, hkv, dh)}
    if kind in MLA_KINDS:
        m = cfg.mla
        return {"c_kv": z(batch, max_len, m.kv_lora_rank),
                "k_rope": z(batch, max_len, 1, m.qk_rope_head_dim)}
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    if kind in MAMBA_KINDS:
        return {"conv": z(batch, s.d_conv - 1, d_in),
                "h": z(batch, d_in, s.d_state, dtype=f32)}
    if kind == "mlstm":
        nh, dh = s.num_heads, d_in // s.num_heads
        return {"conv": z(batch, s.d_conv - 1, d_in),
                "C": z(batch, nh, dh, dh, dtype=f32),
                "n": z(batch, nh, dh, dtype=f32),
                "m": z(batch, nh, dtype=f32)}
    if kind == "slstm":
        D = cfg.d_model
        return {"conv": z(batch, s.d_conv - 1, D),
                **{k: z(batch, D, dtype=f32) for k in ("c", "n", "h", "m")}}
    raise ValueError(kind)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *,
               device="cuda") -> List[Dict[str, torch.Tensor]]:
    """Contiguous caches, one dict per layer: one ``max_len`` row per batch
    row for KV layers, one state row per batch row for recurrent ones."""
    _check_ported(cfg)
    dev = resolve_device(device)
    return [_block_cache(cfg, kind, batch, max_len, device=dev)
            for kind in cfg.layer_pattern]


def init_paged_cache(cfg: ArchConfig, num_blocks: int, block_size: int, *,
                     device="cuda") -> List[Dict[str, torch.Tensor]]:
    """Pooled paged cache, one dict per layer (axis 0 = PHYSICAL BLOCK):
    attention layers {"k", "v"}, each [num_blocks, block_size, Hkv, Dh];
    MLA layers the latent pair {"c_kv": [num_blocks, block_size, r],
    "k_rope": [num_blocks, block_size, 1, dr]}.  Positional caches only: a
    recurrent state has no positions to page."""
    for kind in cfg.layer_pattern:
        if kind in REC_KINDS:
            raise ValueError(
                f"{cfg.name}: layer kind {kind!r} has a recurrent cache; "
                "the paged backend supports attention/MLA only — use "
                "init_hybrid_cache for mixed stacks")
    return init_cache(cfg, num_blocks, block_size, device=device)


def init_hybrid_cache(cfg: ArchConfig, *, kv_batch: int, kv_len: int,
                      rec_batch: int, device="cuda"
                      ) -> List[Dict[str, torch.Tensor]]:
    """SlotState cache for mixed stacks: each layer's leaves sized by its
    backend.  Positional (attention / MLA) leaves get the KV geometry:
    ``(kv_batch, kv_len)`` is ``(max_slots, max_len)`` for the contiguous
    backend or ``(num_blocks, block_size)`` for the paged one.  Recurrent
    leaves get ``rec_batch`` pooled state rows (row 0 is the sentinel row
    masked decode slots address, so pass usable rows + 1)."""
    _check_ported(cfg)
    dev = resolve_device(device)
    return [_block_cache(cfg, kind, rec_batch, 0, device=dev)
            if kind in REC_KINDS else
            _block_cache(cfg, kind, kv_batch, kv_len, device=dev)
            for kind in cfg.layer_pattern]


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
    if cfg.frontend:
        params["frontend_proj"] = L._init_dense(
            cfg.frontend_dim or D, D, dtype=dt, device=dev, generator=gen)
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


def _embed(params, cfg: ArchConfig, tokens, frontend_embeds=None,
           positions=None):
    """Token embeddings [B,T,D], after the projected frontend embeddings
    [B,Tf,D] when given, plus the sinusoidal table for ``positions`` (1-D,
    broadcast over rows, or [B,T]; default 0..Tf+T-1) when the model uses
    it."""
    h = F.embedding(tokens, params["embed"])
    if cfg.embed_scale:
        h = h * math.sqrt(cfg.d_model)
    if cfg.frontend and frontend_embeds is not None:
        pre = L.dense(params["frontend_proj"], frontend_embeds.to(h.dtype))
        h = torch.cat([pre, h], dim=1)
    if cfg.pos_embed == "sinusoidal":
        if positions is None:
            positions = torch.arange(h.shape[1], dtype=torch.int32,
                                     device=h.device)
        h = h + L.sinusoidal_pos(positions, cfg.d_model).to(h.dtype)
    return ACT.hidden(h)


def _prefix_len(cfg: ArchConfig):
    """The bidirectional prefix of a prefix-LM (None: causal throughout)."""
    return cfg.frontend_tokens if cfg.prefix_lm else None


def _run_segments(params, cfg: ArchConfig, h, *, positions, caches=None,
                  offset=None, prefix_len=None, block_tables=None,
                  paged_kernel="auto", rec_rows=None, update_mask=None):
    """Run every layer in order, unit by unit of ``cfg.segments()`` (the
    reference scans each segment's stacked unit over its repeats).
    Returns ``(h, new caches, aux)``.  Without caches (training and
    ``forward``): new caches are None, ``aux`` is the MoE balance loss
    summed per unit, then over a segment's units, then over segments, as
    the reference sums it, and while gradients flow each unit runs under
    ``torch.utils.checkpoint`` (``_REMAT``).  With caches (serving): the
    new caches, and ``aux`` None."""
    if caches is not None:
        new_caches, first = [], 0
        for unit, reps in cfg.segments():
            for _ in range(reps):
                for j, kind in enumerate(unit):
                    h, nc, _aux = apply_block(
                        params["layers"][first + j], cfg, kind, h,
                        positions=positions, cache=caches[first + j],
                        offset=offset, prefix_len=prefix_len,
                        block_tables=block_tables,
                        paged_kernel=paged_kernel, rec_rows=rec_rows,
                        update_mask=update_mask)
                    new_caches.append(nc)
                h = ACT.hidden(h)
                first += len(unit)
        return h, new_caches, None

    def run_unit(h, first, unit):
        aux_sum = torch.zeros((), dtype=torch.float32, device=h.device)
        for j, kind in enumerate(unit):
            h, _, aux = apply_block(params["layers"][first + j], cfg, kind,
                                    h, positions=positions,
                                    prefix_len=prefix_len)
            aux_sum = aux_sum + aux
        return ACT.hidden(h), aux_sum

    remat = torch.is_grad_enabled() and _REMAT == "block"
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    first = 0
    for unit, reps in cfg.segments():
        auxs = []
        for _ in range(reps):
            if remat:
                h, aux_sum = checkpoint(run_unit, h, first, unit,
                                        use_reentrant=False)
            else:
                h, aux_sum = run_unit(h, first, unit)
            auxs.append(aux_sum)
            first += len(unit)
        aux_total = aux_total + torch.stack(auxs).sum()
    return h, None, aux_total


def _head(params, cfg: ArchConfig, h):
    w = params["embed"].T if cfg.tie_embeddings else params["head"]["w"]
    logits = ACT.logits((h @ w).float())
    return L.softcap(logits, cfg.logit_softcap)


# ---------------------------------------------------------------------------
# training: full-sequence forward and the chunked loss
# ---------------------------------------------------------------------------


def forward(params, cfg: ArchConfig, tokens, frontend_embeds=None,
            positions=None):
    """Full-sequence logits [B,Tf+T,V] f32 (small vocab / small T only —
    training uses ``loss_fn``, which chunks the head).  ``positions``
    reach the attention layers only; the sinusoidal table is taken at
    0..Tf+T-1, as the reference's."""
    _check_ported(cfg)
    h = _embed(params, cfg, tokens, frontend_embeds)
    if positions is None:
        positions = torch.arange(h.shape[1], dtype=torch.int32,
                                 device=tokens.device)
    h, _, _ = _run_segments(params, cfg, h, positions=positions,
                            prefix_len=_prefix_len(cfg))
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
    """batch: {tokens [B,T], labels [B,T]} (integer tensors), and for
    frontend models {frontend [B,Tf,Df]} (f32); labels < 0 are masked and
    the loss is taken over the text positions.  Returns (loss, metrics)
    as the reference's: metrics
    {"xent", "aux"} (aux is the MoE balance loss, summed over blocks),
    and "mtp" (the MTP modules' summed cross-entropy) for MTP models;
    loss = xent + mtp_loss_weight * mtp / mtp_depth + 0.01 * aux (the aux
    term for MoE stacks only)."""
    _check_ported(cfg)
    tokens, labels = batch["tokens"], batch["labels"]
    frontend = batch.get("frontend")
    h = _embed(params, cfg, tokens, frontend)
    positions = torch.arange(h.shape[1], dtype=torch.int32,
                             device=tokens.device)
    h, _, aux = _run_segments(params, cfg, h, positions=positions,
                              prefix_len=_prefix_len(cfg))
    h = L.rms_norm(params["final_norm"], h, cfg.norm_eps)
    if cfg.frontend and frontend is not None:
        h = h[:, cfg.frontend_tokens:]                  # the text positions
    mask = (labels >= 0).float()
    loss = _chunked_xent(params, cfg, h, torch.clamp(labels, min=0), mask)
    metrics = {"xent": loss, "aux": aux}

    if cfg.mtp_depth and "mtp" in params:
        # DeepSeek MTP: module i predicts token t+1+i from [h_t ; emb_{t+i}]
        mtp_loss = torch.zeros((), dtype=torch.float32, device=h.device)
        h_cur = h
        kind = "mla" if cfg.mla else "attn"
        for i, mod in enumerate(params["mtp"]):
            emb_next = F.embedding(tokens[:, 1 + i:], params["embed"])
            h_in = torch.cat([h_cur[:, :emb_next.shape[1]],
                              emb_next.to(h_cur.dtype)], dim=-1)
            h_i = L.dense(mod["proj"], h_in)
            pos_i = torch.arange(h_i.shape[1], dtype=torch.int32,
                                 device=h.device)
            h_i, _, _ = apply_block(mod["block"], cfg, kind, h_i,
                                    positions=pos_i)
            h_i = L.rms_norm(mod["norm"], h_i, cfg.norm_eps)
            lbl_i = labels[:, 1 + i:]
            msk_i = (lbl_i >= 0).float()
            mtp_loss = mtp_loss + _chunked_xent(
                params, cfg, h_i, torch.clamp(lbl_i, min=0), msk_i)
            h_cur = h_i
        loss = loss + cfg.mtp_loss_weight * mtp_loss / cfg.mtp_depth
        metrics["mtp"] = mtp_loss

    if cfg.moe:
        loss = loss + 0.01 * aux
    return loss, metrics


# ---------------------------------------------------------------------------
# inference: prefill + decode over the contiguous, paged or hybrid cache
# ---------------------------------------------------------------------------


def prefill(params, cfg: ArchConfig, tokens, cache, frontend_embeds=None):
    """Fill the cache with the prompt [B,T], after the frontend embeddings
    [B,Tf,Df] when given, from position 0 (the wave oracle's batch
    prefill; a frontend model's decode); returns (logits [B,1,V] of the
    last position, cache, Tf+T)."""
    h = _embed(params, cfg, tokens, frontend_embeds)
    T = h.shape[1]
    positions = torch.arange(T, dtype=torch.int32, device=tokens.device)
    h, new_caches, _ = _run_segments(params, cfg, h, positions=positions,
                                     caches=cache, offset=0,
                                     prefix_len=_prefix_len(cfg))
    h_last = L.rms_norm(params["final_norm"], h[:, -1:], cfg.norm_eps)
    return _head(params, cfg, h_last), new_caches, T


def decode_step(params, cfg: ArchConfig, token, cache, offset,
                block_tables=None, paged_kernel="auto", rec_rows=None,
                active=None):
    """token: [B,1] ints; offset: tokens already cached — a scalar or a
    per-row [B] tensor.  Without ``block_tables`` the KV layers use the
    contiguous cache (one row per batch row; attention over the whole row,
    as the reference, outside any kernel).  ``block_tables`` [B, n]
    addresses the paged pools instead; there ``paged_kernel="auto"`` (the
    default) routes attention through ``kernels.paged_attention`` (the
    CUDA kernel on a CUDA cache, its plain version on the CPU) and
    ``"ref"`` gathers, then attends.  Caches are written in place.

    Recurrent layers: ``rec_rows`` [B] addresses each batch row's pooled
    state row and ``active`` [B] bool gates the state advance — inactive
    rows map to the sentinel row 0 and leave it unchanged."""
    B = token.shape[0]
    dev = token.device
    off = torch.as_tensor(offset, dtype=torch.int32, device=dev)
    if off.ndim == 1:
        positions = off[:, None]
    else:
        positions = off.reshape(1, 1).expand(B, 1)
    update_mask = None
    if active is not None:
        update_mask = torch.as_tensor(active, device=dev).reshape(B, 1)             .to(torch.bool)
    h = _embed(params, cfg, token, positions=positions)
    h, new_caches, _ = _run_segments(params, cfg, h, positions=positions,
                                  caches=cache, offset=off,
                                  block_tables=block_tables,
                                  paged_kernel=paged_kernel,
                                  rec_rows=rec_rows, update_mask=update_mask)
    h = L.rms_norm(params["final_norm"], h, cfg.norm_eps)
    return _head(params, cfg, h), new_caches


def prefill_chunk(params, cfg: ArchConfig, tokens, cache, offset,
                  with_logits: bool = True, block_tables=None,
                  rec_rows=None, valid=None):
    """Write a prompt chunk [B,T] at cache positions [offset, offset+T)
    (the contiguous cache, or the paged pools through ``block_tables``).

    Returns logits for the WHOLE chunk [B,T,V] (the engine picks the real
    last position) — or None with ``with_logits=False``, which skips the
    full-vocab head on interior chunks — and the updated cache.

    Positional caches tolerate padding anywhere (garbage positions stay
    causally hidden until overwritten); recurrent caches would advance on
    it, so recurrent-bearing archs pass ``valid``, the count of real
    tokens from the chunk start, and ``rec_rows`` [B] addressing the
    pooled state rows: the state advances over exactly the first
    ``valid`` positions and freezes on the padded tail."""
    B, T = tokens.shape
    if T >= L.QUERY_CHUNK_THRESHOLD:
        raise ValueError(
            f"prefill chunk length {T} >= {L.QUERY_CHUNK_THRESHOLD}: "
            "offset prefill must stay below the blocked-attention "
            "threshold — use smaller chunks")
    dev = tokens.device
    off = int(offset)
    ar = torch.arange(T, dtype=torch.int32, device=dev)
    positions = (off + ar)[None, :].expand(B, T)
    update_mask = None
    if valid is not None:
        update_mask = (ar < int(valid))[None, :].expand(B, T)
    h = _embed(params, cfg, tokens, positions=positions)
    h, new_caches, _ = _run_segments(params, cfg, h, positions=positions,
                                  caches=cache, offset=off,
                                  block_tables=block_tables,
                                  rec_rows=rec_rows, update_mask=update_mask)
    if not with_logits:
        return None, new_caches
    h = L.rms_norm(params["final_norm"], h, cfg.norm_eps)
    return _head(params, cfg, h), new_caches


# ---------------------------------------------------------------------------
# per-slot cache surgery (serve engine)
# ---------------------------------------------------------------------------
#
# Cache leaves are per layer [B, ...]: axis 0 is the slot row of a
# contiguous KV leaf, the physical block of a paged one, the pooled state
# row of a recurrent one.  Admission takes a slot's view, prefills it and
# writes it back; completion resets the slot.  The views share the cache's
# storage, so a prefill into one already lands in place and the write-back
# copies nothing.


def _take(x, slot: int):
    return x[slot:slot + 1]


def _put(x, y, slot: int) -> None:
    dst = x[slot:slot + 1]
    if not (y.data_ptr() == dst.data_ptr() and y.stride() == dst.stride()
            and y.shape == dst.shape and y.dtype == dst.dtype):
        dst.copy_(y)


def _map_layers(cfg, cache, fn_for_kind):
    """Apply ``fn_for_kind(kind) -> leaf_fn | None`` over each layer's
    leaves (None = leave the layer's leaves as they are)."""
    out = []
    for kind, layer in zip(cfg.layer_pattern, cache):
        fn = fn_for_kind(kind)
        out.append(layer if fn is None else
                   {k: fn(x) for k, x in layer.items()})
    return out


def take_slot(cache, slot: int):
    """One slot's cache as a batch-1 view (leaves [1, ...])."""
    return [{k: _take(x, slot) for k, x in layer.items()} for layer in cache]


def write_slot(cache, sub, slot: int):
    """Write a batch-1 slot cache (from ``take_slot``) back at ``slot``."""
    for layer, s in zip(cache, sub):
        for k, x in layer.items():
            _put(x, s[k], slot)
    return cache


def reset_slot(cache, slot: int):
    """Zero one slot's rows in every cache leaf, other slots untouched."""
    for layer in cache:
        for x in layer.values():
            x[slot].zero_()
    return cache


# Kind-aware variants (the SlotState protocol): in a hybrid cache axis 0
# means "slot row" for contiguous KV leaves, "physical block" for paged
# ones and "pooled state row" for recurrent ones, so slot surgery walks
# the config beside the cache and touches only the leaves whose backend it
# addresses.


def take_state(cfg: ArchConfig, cache, slot: int):
    """One contiguous-KV slot's rows as a batch-1 view; recurrent leaves
    pass through WHOLE (the forward addresses them by ``rec_rows``)."""
    return _map_layers(cfg, cache, lambda kind: None if kind in REC_KINDS
                       else (lambda x: _take(x, slot)))


def write_state(cfg: ArchConfig, cache, sub, slot: int):
    """Write a ``take_state`` view back: contiguous-KV leaves land in the
    slot's row; recurrent leaves come back whole (the forward already
    scattered their rows in place)."""
    out = []
    for kind, full, s in zip(cfg.layer_pattern, cache, sub):
        if kind in REC_KINDS:
            out.append(s)
            continue
        for k, x in full.items():
            _put(x, s[k], slot)
        out.append(full)
    return out


def reset_slot_state(cfg: ArchConfig, cache, slot=None, rec_row=None):
    """Zero a contiguous-KV slot row (``slot``) and/or a pooled recurrent
    state row (``rec_row``); None leaves that backend untouched (paged KV
    leaves are never touched: block freshness is the allocator's job)."""
    for kind, layer in zip(cfg.layer_pattern, cache):
        row = rec_row if kind in REC_KINDS else slot
        if row is not None:
            for x in layer.values():
                x[row].zero_()
    return cache


def copy_block(cache, src: int, dst: int):
    """Copy one physical block's payload in every paged-cache leaf, in
    place (the device half of copy-on-write)."""
    for layer in cache:
        for pool in layer.values():
            pool[dst].copy_(pool[src])
    return cache
