"""BSP training step on one device (port of ``repro/runtime/trainer.py``,
the explicit-schedule tier ``make_bsp_train_step``).

A BSP world of W ranks is the leading axis of every per-rank tensor on one
device (see ``core/collectives.py``):

  * packed f32 gradients and the EF residual are ``[W, L]`` per bucket;
  * the ZeRO-1 moments are ``[W, shard_total]``, one shard per rank;
  * the params are identical on every rank after the all-gather, so ONE
    copy is kept (the port's per-layer dict) and updated in place.

One superstep, in the reference's order (trainer.py:355-417):

  compute      each rank's loss and gradients on its slice of the global
               batch (``grad_accum`` micro-batches each), through
               ``torch.autograd.grad``: the ranks share one parameter copy,
               so ``.backward()`` would add their gradients together;
  pack         rank r's gradients into row r of each bucket, in the
               reference's leaf order (``weights.reference_leaves``);
  per bucket   EF on the codec'd buckets (``corrected - res``, literally),
               reduce-scatter with the bucket's schedule (the fractal one
               with the wire codec on every halving hop: the B1/B2
               decode-add kernels on the card; any other through its
               Schedule-IR all-reduce and a slice), ZeRO-1 AdamW on
               each rank's shard, all-gather of the updated shards;
  barrier      one fsync token closes the superstep.

To fit the card, the EF residual, the moments and the params are updated
in place, and each bucket's gradient payload is dropped once it is
reduced; the arithmetic is the reference's.  ``shares=`` (uneven per-rank
micro-batches) comes with a later slice; ``make_gspmd_train_step`` has no
counterpart on one device.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import collectives as C
from repro_torch.core.bsp import BSPConfig
from repro_torch.core.superstep import engine_for
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.optim.compression import quantization_error
from repro_torch.weights import reference_leaves


@dataclass
class BSPTrainState:
    params: Dict[str, Any]           # one copy: identical on every rank
    flat_mu: torch.Tensor            # [W, shard_total] ZeRO-1 moment shards
    flat_nu: torch.Tensor
    ef_residual: Optional[torch.Tensor]   # [W, total_padded] EF state
    step: int


def _adamw_flat(p, g, mu, nu, step: int, acfg: adamw.AdamWConfig):
    """AdamW on flat f32 shards (any leading rank axis).  The global-norm
    clip is not applied, as in the reference's ZeRO-1 update."""
    b1, b2 = acfg.beta1, acfg.beta2
    stepf = torch.tensor(step + 1, dtype=torch.float32, device=p.device)
    lr = adamw.schedule(step, acfg, device=p.device)
    mu = b1 * mu + (1 - b1) * g
    nu = b2 * nu + (1 - b2) * torch.square(g)
    mhat = mu / (1 - b1 ** stepf)
    nhat = nu / (1 - b2 ** stepf)
    upd = mhat / (torch.sqrt(nhat) + acfg.eps) + acfg.weight_decay * p
    return p - lr * upd, mu, nu, {"lr": lr}


def _split(batch: Dict[str, torch.Tensor], n: int) -> List[Dict]:
    rows = next(iter(batch.values())).shape[0]
    if rows % n:
        raise ValueError(f"batch of {rows} rows does not split into {n}")
    k = rows // n
    return [{key: v[i * k:(i + 1) * k] for key, v in batch.items()}
            for i in range(n)]


def make_bsp_train_step(cfg: ArchConfig, acfg: adamw.AdamWConfig,
                        bsp: BSPConfig, world: int, grad_accum: int = 1,
                        device="cuda",
                        shares: Optional[Sequence[int]] = None):
    """The explicit-schedule BSP superstep over a world of ``world`` ranks
    held on one device.  Returns ``(step_fn, init_state)``:
    ``init_state(params) -> BSPTrainState`` and ``step_fn(state, batch) ->
    (state, metrics)``, where ``batch`` holds the GLOBAL batch (``tokens``,
    ``labels``, ``[B, T]`` integers; rank r takes rows
    ``[r·B/W, (r+1)·B/W)``) and metrics the world-mean ``loss``, ``xent``,
    ``aux`` and the ``lr`` as f32 scalars.  ``init_state.superstep_layout``
    is the reference's moment-layout tag."""
    if shares is not None:
        raise NotImplementedError(
            "shares= (uneven per-rank micro-batches) comes with a later "
            "slice of the port")
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    dev = resolve_device(device)
    rev = C.bit_reversed_index(world, dev)   # raises unless a power of two
    shapes = reference_leaves(T.init_params(cfg, device="meta"), cfg)
    # the flat layout is f32 (grads and moments are f32 whatever the param
    # dtype); zero1 prices the picks as this lowering runs them
    engine = engine_for(shapes, bsp, world, force_dtype=torch.float32,
                        zero1=True)
    bucket_codecs = engine.bucket_codecs
    has_codec = any(c is not None for c in bucket_codecs)
    wire_codecs = bucket_codecs if bsp.bucket_codec is not None \
        else (None,) * engine.n_buckets
    print(f"superstep: {engine.describe()} (link={engine.link.name})")
    layout = ",".join(f"{b.offset}+{b.length}" for b in engine.buckets)
    layout_tag = "zero1:" + hashlib.sha1(
        f"w{world}:{layout}".encode()).hexdigest()[:12]
    shard_lens = [engine.shard_len(b) for b in engine.buckets]
    shard_offs = engine.shard_offsets()
    f32 = torch.float32

    def rank_grads(params, flat_params, batch):
        """(loss, metrics, grads) of one rank, averaged over its
        ``grad_accum`` micro-batches (summed in micro-batch order, then
        scaled, as the reference's scan does)."""
        acc = None
        with torch.enable_grad():
            for mb in _split(batch, grad_accum):
                loss, metrics = T.loss_fn(params, cfg, mb)
                grads = torch.autograd.grad(loss, flat_params)
                cur = (loss.detach(), {k: v.detach()
                                       for k, v in metrics.items()}, grads)
                if acc is None:
                    acc = cur
                else:
                    acc = (acc[0] + cur[0],
                           {k: acc[1][k] + cur[1][k] for k in acc[1]},
                           [a + g for a, g in zip(acc[2], cur[2])])
        if grad_accum == 1:
            return acc
        inv = 1.0 / grad_accum
        return (acc[0] * inv, {k: v * inv for k, v in acc[1].items()},
                [g * inv for g in acc[2]])

    def step_fn(state: BSPTrainState, batch):
        leaves = reference_leaves(state.params, cfg)
        flat_params = [t for leaf in leaves for t in leaf.parts]
        batch = {k: torch.as_tensor(batch[k], device=dev)
                 for k in ("tokens", "labels")}

        # --- compute: each rank's gradients into its row of every bucket
        g_parts: List[Optional[torch.Tensor]] = [
            torch.zeros(world, b.length, dtype=f32, device=dev)
            for b in engine.buckets]
        losses, metric_rows = [], []
        for r, batch_r in enumerate(_split(batch, world)):
            loss, metrics, grads = rank_grads(state.params, flat_params,
                                              batch_r)
            it = iter(grads)
            grouped = [[next(it) for _ in leaf.parts] for leaf in leaves]
            engine.pack(grouped, out=[g[r] for g in g_parts])
            del grads, grouped, it
            losses.append(loss)
            metric_rows.append(metrics)
        # the GLOBAL mean loss and metrics (each rank saw its own rows)
        loss = torch.stack(losses).sum() / world
        metrics = {k: torch.stack([m[k] for m in metric_rows]).sum() / world
                   for k in metric_rows[0]}

        # --- per bucket: EF → reduce-scatter → ZeRO-1 AdamW → all-gather
        new_p_parts, om = [], {}
        with torch.no_grad():
            for bkt, schedule, c, wc, s_len, s_off in zip(
                    engine.buckets, engine.schedules, bucket_codecs,
                    wire_codecs, shard_lens, shard_offs):
                g = g_parts[bkt.index]
                g_parts[bkt.index] = None         # drop it once reduced
                if c is not None:
                    # EF-SGD, in place: corrected = g + res; the wire
                    # carries corrected - quantization_error(corrected)
                    res = state.ef_residual[:, bkt.offset:
                                            bkt.offset + bkt.length]
                    g.add_(res)
                    new_res = quantization_error(g, c)
                    res.copy_(new_res)
                    g.sub_(new_res)
                    del new_res
                g_shard = engine.reduce_scatter_bucket(
                    g, schedule, codec=wc) / world
                del g
                p_part = engine.pack_bucket(bkt, leaves, dtype=f32)
                p_shard = p_part.view(world, s_len)[rev]
                mu_b = state.flat_mu[:, s_off:s_off + s_len]
                nu_b = state.flat_nu[:, s_off:s_off + s_len]
                new_p, new_mu, new_nu, om = _adamw_flat(
                    p_shard, g_shard, mu_b, nu_b, state.step, acfg)
                mu_b.copy_(new_mu)
                nu_b.copy_(new_nu)
                del p_part, p_shard, g_shard, new_mu, new_nu
                # publish: the all-gather inverts the bit-reversed scatter;
                # every rank's row is the same, keep one
                new_p_parts.append(engine.all_gather_bucket(new_p)[0].clone())
                del new_p

            for leaf, new in zip(leaves, engine.unpack(new_p_parts, leaves)):
                for part, src in zip(leaf.parts,
                                     new.reshape(len(leaf.parts), -1)):
                    part.copy_(src.view(part.shape))
            del new_p_parts

            # --- one fsync token closes the superstep
            token = C.fractal_barrier(world, level=bsp.fsync_level,
                                      device=dev)
            domain = world if bsp.fsync_level is None \
                else 1 << bsp.fsync_level
            if not bool((token == domain).all()):
                raise RuntimeError(f"fsync tokens {token.tolist()} != "
                                   f"{domain}")
        state.step += 1
        return state, dict(metrics, loss=loss, **om)

    def init_state(params) -> BSPTrainState:
        shard_total = sum(shard_lens)
        for leaf in reference_leaves(params, cfg):
            for t in leaf.parts:
                if t.device != dev:
                    raise ValueError(f"{leaf.path} is on {t.device}, the "
                                     f"step runs on {dev}")
                t.requires_grad_(True)
        mu = torch.zeros(world, shard_total, dtype=f32, device=dev)
        nu = torch.zeros(world, shard_total, dtype=f32, device=dev)
        # EF residual: PER-RANK state of the full bucket-ordered length
        ef = torch.zeros(world, engine.total_padded, dtype=f32, device=dev) \
            if has_codec else None
        return BSPTrainState(params, mu, nu, ef, 0)

    init_state.superstep_layout = layout_tag
    init_state.engine = engine
    return step_fn, init_state
