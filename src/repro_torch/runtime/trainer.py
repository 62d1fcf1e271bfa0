"""Training and serving step builders on one device (port of
``repro/runtime/trainer.py``).  Two tiers, as the reference's:

  * ``make_gspmd_train_step`` (Tier A, ``--schedule xla``): the GSPMD
    baseline.  The reference jits ``loss_fn`` on the global batch with
    FSDP×TP shardings and lets XLA schedule the gradient reduction.  GSPMD's
    contract is that the sharded program computes the unsharded one; a
    mesh here is virtual devices on one torch device
    (``launch/mesh.py``), so the step is that program: ``loss_fn`` on the
    GLOBAL batch in one forward and backward, then the pytree AdamW with
    the global-norm clip (``optim.adamw.apply_updates``), and no
    communication.  It does not split the batch into per-rank losses: the
    MoE balance loss and the frontend text mask are means over the global
    batch.  The builders return the reference's specs (params FSDP×TP,
    AdamW moments alike, batch over the FSDP axes) and set the
    ``act_sharding`` policy as the reference's do;
    ``make_prefill_step`` / ``make_decode_step`` are the serving steps of
    the same tier (params in ``_serve_mode``'s layout).
  * ``make_bsp_train_step`` (Tier B): the explicit-schedule superstep.

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
  per bucket   EF on the codec'd buckets (``corrected - res``, literally;
               ``kernels/codec``: one kernel launch a bucket on the card,
               the eager sequence on the CPU), reduce-scatter with the
               bucket's schedule (the fractal one with the wire codec on
               every halving hop: the B1/B2
               decode-add kernels on the card; any other through its
               Schedule-IR all-reduce and a slice), ZeRO-1 AdamW on
               each rank's shard, all-gather of the updated shards;
  barrier      one fsync token closes the superstep.

The phases are spans (``runtime/spans.py``), recorded only while a
``torch.profiler`` is active: ``bsp.step`` holds ``bsp.compute`` (compute
and pack) and ``bsp.sync`` (the rest), which holds each bucket's
``bsp.ef``, ``bsp.reduce_scatter``, ``bsp.zero1`` and ``bsp.all_gather``.

To fit the card, the EF residual, the moments and the params are updated
in place, and each bucket's gradient payload is dropped once it is
reduced; the arithmetic is the reference's.

``shares=`` (uneven per-rank micro-batches, trainer.py:279-353 of the
reference) replaces the compute phase: rank r runs its ``shares[r]``
micro-batches and accumulates each one's f32 gradients (and loss and
metrics) into a Neumaier compensated pair ``(s, e)``; the pairs are held
packed in the bucket layout, ``[W, L]`` f32 each per bucket.  The
combine then runs in the fixed canonical order (every rank's ``s`` row,
then every ``e`` row, then ``(ts + te) / sum(shares)``), so any partition
of the same micro-batches gives the same bits; the combined gradient is
written into all W rows, and the reduce-scatter over those identical
copies, divided by W, recovers it exactly.  Neumaier's step is written
literally (no fused or reassociated form: a ``torch.sum`` over the rank
axis would round in another order), elementwise in chunks so that its
temporaries stay small.
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
from repro_torch.kernels.codec import ops as codec_ops
from repro_torch.models import act_sharding as ACT
from repro_torch.models import sharding as SH
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.runtime import spans
from repro_torch.weights import reference_leaves


# ---------------------------------------------------------------------------
# Tier A: the GSPMD step (the --schedule xla baseline)
# ---------------------------------------------------------------------------


def _host_leaves(tree, cfg: ArchConfig) -> List[torch.Tensor]:
    """A params-shaped tree as the reference's layer-stacked leaves, copied
    to host memory now."""
    out = []
    for leaf in reference_leaves(tree, cfg):
        host = torch.empty(leaf.shape, dtype=leaf.dtype)
        rows = host.view(len(leaf.parts), -1)
        for row, part in zip(rows, leaf.parts):
            row.copy_(part.detach().reshape(-1))
        out.append(host)
    return out


def _load_leaves(tree, cfg: ArchConfig, srcs) -> Any:
    """A new tree shaped, typed and placed like the params-shaped ``tree``,
    holding the reference's stacked leaves ``srcs``."""
    new = _map_tensors(tree, lambda t: torch.empty_like(
        t, requires_grad=False))
    for leaf, dst, src in zip(reference_leaves(tree, cfg),
                              reference_leaves(new, cfg), srcs):
        if tuple(src.shape) != leaf.shape:
            raise ValueError(f"{leaf.path}: checkpoint shape "
                             f"{tuple(src.shape)} != {leaf.shape}")
        for part, row in zip(dst.parts, src.reshape(len(dst.parts), -1)):
            part.copy_(row.reshape(part.shape))
    return new


def _flat_parts(tree, cfg: ArchConfig) -> List[torch.Tensor]:
    return [t for leaf in reference_leaves(tree, cfg) for t in leaf.parts]


@dataclass
class GSPMDTrainState:
    """The reference's ``(params, AdamWState)``: params one dict per layer,
    the AdamW moments trees of the same shape."""

    params: Dict[str, Any]
    opt: adamw.AdamWState
    cfg: ArchConfig

    def __post_init__(self):
        for t in _flat_parts(self.params, self.cfg):
            t.requires_grad_(True)

    @property
    def device(self) -> torch.device:
        return self.opt.step.device

    # -- checkpoint leaves: (params, AdamWState(step, mu, nu)) -----------

    def checkpoint_leaves(self) -> List[torch.Tensor]:
        """The reference's leaves of ``(params, opt_state)``, copied to host
        memory now: the params', the step (int32), mu's, nu's."""
        return (_host_leaves(self.params, self.cfg)
                + [self.opt.step.detach().to("cpu", copy=True)]
                + _host_leaves(self.opt.mu, self.cfg)
                + _host_leaves(self.opt.nu, self.cfg))

    def checkpoint_leaf_count(self) -> int:
        return 3 * len(reference_leaves(self.params, self.cfg)) + 1

    def checkpoint_descriptor(self) -> str:
        n = len(reference_leaves(self.params, self.cfg))
        return (f"repro_torch GSPMDTrainState: ({n} params leaves, "
                f"AdamWState(step, {n} mu leaves, {n} nu leaves))")

    def from_checkpoint_leaves(self, leaves) -> "GSPMDTrainState":
        """A new state shaped, typed and placed like this one, holding the
        checkpoint's ``leaves`` (``checkpoint_leaves`` order)."""
        n = len(reference_leaves(self.params, self.cfg))
        step = leaves[n].reshape(()).to(torch.int32).to(self.device)
        opt = adamw.AdamWState(
            step=step, mu=_load_leaves(self.opt.mu, self.cfg,
                                       leaves[n + 1:2 * n + 1]),
            nu=_load_leaves(self.opt.nu, self.cfg, leaves[2 * n + 1:]))
        return GSPMDTrainState(_load_leaves(self.params, self.cfg,
                                            leaves[:n]), opt, self.cfg)


def _mesh_device(mesh) -> torch.device:
    if mesh.device is None:
        raise ValueError(f"{mesh!r} is abstract: a step needs a mesh on a "
                         "torch device (launch.mesh.make_mesh)")
    return mesh.device


def make_gspmd_train_step(cfg: ArchConfig, mesh, acfg: adamw.AdamWConfig):
    """``(step, (pspec, ospec, bspec))``: ``step(state, batch) -> (state,
    metrics)`` on a ``GSPMDTrainState``, ``batch`` the GLOBAL batch
    (``tokens``, ``labels``, and ``frontend`` for frontend models), metrics
    ``loss_fn``'s with ``loss``, ``grad_norm`` and ``lr``; the specs as
    the reference's (``{leaf path: P}`` in its leaf order for the params,
    ``AdamWState(step=P(), mu=pspec, nu=pspec)``, the batch's)."""
    dev = _mesh_device(mesh)
    ACT.set_policy(mesh, SH.fsdp_axes(mesh))
    ACT.SERVE_EP = False

    def train_step(state: GSPMDTrainState, batch):
        batch = {k: torch.as_tensor(batch[k], device=dev)
                 for k in BATCH_KEYS if k in batch}
        flat = _flat_parts(state.params, cfg)
        with torch.enable_grad():
            loss, metrics = T.loss_fn(state.params, cfg, batch)
            grads = torch.autograd.grad(loss, flat)
        opt = state.opt
        _, new, om = adamw.apply_updates(
            flat, list(grads), adamw.AdamWState(
                opt.step, _flat_parts(opt.mu, cfg), _flat_parts(opt.nu, cfg)),
            acfg)
        del grads
        state.opt = adamw.AdamWState(new.step, opt.mu, opt.nu)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return state, dict(metrics, loss=loss.detach(), **om)

    pspec = SH.param_specs(cfg, None, mesh)
    ospec = adamw.AdamWState(step=SH.P(), mu=pspec, nu=pspec)
    bspec_all = SH.batch_spec(mesh)
    bspec = {"tokens": bspec_all["tokens"], "labels": bspec_all["labels"]}
    if cfg.frontend:
        bspec["frontend"] = bspec_all["frontend"]
    return train_step, (pspec, ospec, bspec)


# ---------------------------------------------------------------------------
# Tier A: serving steps (prefill / decode)
# ---------------------------------------------------------------------------


def _serve_mode(cfg: ArchConfig) -> str:
    """MoE archs serve with pinned weights (TP+EP: tokens move, weights
    stay); dense archs keep the FSDP layout."""
    return "serve" if cfg.moe else "train"


def make_prefill_step(cfg: ArchConfig, mesh, batch: int, max_len: int):
    """``(step, (pspec, cspec))``: ``step(params, tokens, cache,
    frontend=None)`` is ``transformer.prefill``; the specs as the
    reference's for a ``[batch, max_len]`` contiguous cache."""
    _mesh_device(mesh)
    ACT.set_policy(mesh, SH.fsdp_axes(mesh))
    ACT.SERVE_EP = cfg.moe is not None

    def prefill_step(params, tokens, cache, frontend=None):
        with torch.no_grad():
            return T.prefill(params, cfg, tokens, cache, frontend)

    pspec = SH.param_specs(cfg, None, mesh, mode=_serve_mode(cfg))
    cspec = SH.cache_specs(cfg, SH.cache_shapes(cfg, batch, max_len), mesh)
    return prefill_step, (pspec, cspec)


def make_decode_step(cfg: ArchConfig, mesh, batch: int, max_len: int):
    """``(step, (pspec, cspec))``: ``step(params, token, cache, offset) ->
    (logits, cache)`` is ``transformer.decode_step``; the specs as
    ``make_prefill_step``'s."""
    _mesh_device(mesh)
    ACT.set_policy(mesh, SH.fsdp_axes(mesh))
    ACT.SERVE_EP = cfg.moe is not None

    def serve_step(params, token, cache, offset):
        with torch.no_grad():
            return T.decode_step(params, cfg, token, cache, offset)

    pspec = SH.param_specs(cfg, None, mesh, mode=_serve_mode(cfg))
    cspec = SH.cache_specs(cfg, SH.cache_shapes(cfg, batch, max_len), mesh)
    return serve_step, (pspec, cspec)


# ---------------------------------------------------------------------------
# Tier B: the explicit BSP superstep
# ---------------------------------------------------------------------------


@dataclass
class BSPTrainState:
    params: Dict[str, Any]           # one copy: identical on every rank
    flat_mu: torch.Tensor            # [W, shard_total] ZeRO-1 moment shards
    flat_nu: torch.Tensor
    ef_residual: Optional[torch.Tensor]   # [W, total_padded] EF state
    step: int
    cfg: ArchConfig                  # the params' layers (leaf order)

    # -- checkpoint leaves: the reference's state tuple ------------------
    # (params, flat_mu [W·S], flat_nu [W·S], ef [W·total] or a zeros([W])
    # placeholder without a codec, step int32), trainer.py:446-455 there;
    # params as its layer-stacked leaves (``weights.reference_leaves``)

    def checkpoint_leaves(self) -> List[torch.Tensor]:
        """The state as the reference's checkpoint leaves, copied to host
        memory now (the step updates the state in place afterwards)."""
        out = _host_leaves(self.params, self.cfg)
        world = self.flat_mu.shape[0]
        for t in (self.flat_mu, self.flat_nu):
            out.append(t.detach().reshape(-1).to("cpu", copy=True))
        out.append(torch.zeros(world, dtype=torch.float32)
                   if self.ef_residual is None else
                   self.ef_residual.reshape(-1).to("cpu", copy=True))
        out.append(torch.tensor(self.step, dtype=torch.int32))
        return out

    def checkpoint_leaf_count(self) -> int:
        return len(reference_leaves(self.params, self.cfg)) + 4

    def checkpoint_descriptor(self) -> str:
        n = len(reference_leaves(self.params, self.cfg))
        ef = "ef" if self.ef_residual is not None else "ef placeholder"
        return (f"repro_torch BSPTrainState: ({n} params leaves, flat_mu, "
                f"flat_nu, {ef}, step)")

    def from_checkpoint_leaves(self, leaves) -> "BSPTrainState":
        """A new state shaped, typed and placed like this one, holding the
        checkpoint's ``leaves`` (host tensors in ``checkpoint_leaves``
        order, as many as ``checkpoint_leaf_count``).  Raises
        ``ValueError`` if a leaf's size does not fit."""
        n = len(reference_leaves(self.params, self.cfg))

        def fit(src, like):
            if src.numel() != like.numel():
                raise ValueError(f"checkpoint leaf of {src.numel()} "
                                 f"elements for a tensor of {like.numel()}")
            return src.to(like.dtype).reshape(like.shape).to(like.device)

        params = _load_leaves(self.params, self.cfg, leaves[:n])
        for t in _flat_parts(params, self.cfg):
            t.requires_grad_(True)
        mu, nu, ef, step = leaves[n:]
        ef_new = None if self.ef_residual is None \
            else fit(ef, self.ef_residual)
        return BSPTrainState(params, fit(mu, self.flat_mu),
                             fit(nu, self.flat_nu), ef_new,
                             int(step.reshape(())), self.cfg)


def _map_tensors(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tensors(v, fn) for v in tree]
    return tree


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


# elements per chunk of a pair step: elementwise, so chunking changes no
# bit; it bounds the step's temporaries at a few times 64 MB
PAIR_CHUNK = 1 << 24


def _pair_add(s, e, t):
    """One Neumaier step on the compensated pair (s, e): s' = fl(s+t)
    with the rounding error folded into e — (s'+e') carries the exact sum
    to O(eps²).  Written as the reference writes it."""
    x = s + t
    e = e + torch.where(torch.abs(s) >= torch.abs(t), (s - x) + t,
                        (t - x) + s)
    return x, e


def _pair_add_(s, e, t) -> None:
    """``_pair_add`` into the 1-D pair (s, e) in place, chunk by chunk."""
    for a in range(0, s.numel(), PAIR_CHUNK):
        sl = slice(a, a + PAIR_CHUNK)
        x, e_new = _pair_add(s[sl], e[sl], t[sl])
        s[sl].copy_(x)
        e[sl].copy_(e_new)


def _combine(s, e, m_total: int) -> torch.Tensor:
    """Rank-stacked pairs ``[W, L]`` → ``(ts + te) / m_total`` ``[L]``, in
    the fixed canonical order: every rank's s row, then every e row."""
    ts, te = torch.zeros_like(s[0]), torch.zeros_like(s[0])
    for row in s:
        _pair_add_(ts, te, row)
    for row in e:
        _pair_add_(ts, te, row)
    # a true division (a CUDA tensor divided by a host scalar is
    # multiplied by its reciprocal instead)
    return ts.add_(te).div_(torch.tensor(float(m_total), device=ts.device))


# what a step reads of a host batch: every other key is dropped
BATCH_KEYS = ("tokens", "labels", "frontend")


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
    ``labels``, ``[B, T]`` integers, and for frontend models ``frontend``,
    ``[B, Tf, Df]`` f32; rank r takes rows ``[r·B/W, (r+1)·B/W)`` of each)
    and metrics the world-mean ``loss``, ``xent``,
    ``aux`` (and ``mtp`` for MTP models) and the ``lr`` as f32 scalars.  ``init_state.superstep_layout``
    is the reference's moment-layout tag."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if shares is not None:
        if grad_accum != 1:
            raise ValueError(
                "shares= and grad_accum>1 are mutually exclusive: shares IS "
                "the per-rank micro-batch count")
        shares = tuple(int(s) for s in shares)
        if len(shares) != world:
            raise ValueError(
                f"shares has {len(shares)} entries for world size {world}")
        if any(s < 1 for s in shares):
            raise ValueError(f"every rank needs >= 1 micro-batch: {shares}")
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

    def grouped(grads, leaves):
        it = iter(grads)
        return [[next(it) for _ in leaf.parts] for leaf in leaves]

    def even_grads(params, leaves, flat_params, batch):
        """Each rank's gradients into its row of every bucket; the GLOBAL
        mean loss and metrics (each rank saw its own rows)."""
        g_parts = [torch.zeros(world, b.length, dtype=f32, device=dev)
                   for b in engine.buckets]
        losses, metric_rows = [], []
        for r, batch_r in enumerate(_split(batch, world)):
            loss, metrics, grads = rank_grads(params, flat_params, batch_r)
            engine.pack(grouped(grads, leaves), out=[g[r] for g in g_parts])
            del grads
            losses.append(loss)
            metric_rows.append(metrics)
        loss = torch.stack(losses).sum() / world
        metrics = {k: torch.stack([m[k] for m in metric_rows]).sum() / world
                   for k in metric_rows[0]}
        return loss, metrics, g_parts

    def shares_grads(params, leaves, flat_params, batch):
        """Uneven micro-batch accumulation, partition-independent in f32:
        rank r's slice is ``max(shares)`` micro-batch rows, of which it
        runs the first ``shares[r]``, each pair-added into its rows of the
        packed pairs; then the canonical combine.  Returns the GLOBAL mean
        loss and metrics and, in every rank's row of each bucket, the
        combined gradient."""
        n_max, m_total = max(shares), sum(shares)
        rows = next(iter(batch.values())).shape[0]
        if rows % (world * n_max):
            raise ValueError(
                f"batch of {rows} rows does not give each of {world} "
                f"ranks max(shares) = {n_max} micro-batches — re-shard "
                "it with data.pipeline.reshard_for_shares")
        mb = rows // (world * n_max)
        s_parts = [torch.zeros(world, b.length, dtype=f32, device=dev)
                   for b in engine.buckets]
        e_parts = [torch.zeros_like(p) for p in s_parts]
        t_parts = [torch.zeros(b.length, dtype=f32, device=dev)
                   for b in engine.buckets]
        keys = sc_s = sc_e = None
        for r in range(world):
            for i in range(shares[r]):
                lo = (r * n_max + i) * mb
                loss, metrics, grads = rank_grads(
                    params, flat_params,
                    {k: v[lo:lo + mb] for k, v in batch.items()})
                engine.pack(grouped(grads, leaves), out=t_parts)
                del grads
                if keys is None:
                    keys = sorted(metrics)
                    sc_s = torch.zeros(world, 1 + len(keys), dtype=f32,
                                       device=dev)
                    sc_e = torch.zeros_like(sc_s)
                t = torch.stack([loss] + [metrics[k] for k in keys]).to(f32)
                _pair_add_(sc_s[r], sc_e[r], t)
                for s_b, e_b, t_b in zip(s_parts, e_parts, t_parts):
                    _pair_add_(s_b[r], e_b[r], t_b)
        del t_parts
        sc = _combine(sc_s, sc_e, m_total)
        for b in engine.buckets:
            g = _combine(s_parts[b.index], e_parts[b.index], m_total)
            e_parts[b.index] = None
            s_parts[b.index].copy_(g.expand(world, -1))
            del g
        return sc[0], {k: sc[1 + j] for j, k in enumerate(keys)}, s_parts

    def step_fn(state: BSPTrainState, batch):
        with spans.step("bsp.step", state.step, dev):
            leaves = reference_leaves(state.params, cfg)
            flat_params = [t for leaf in leaves for t in leaf.parts]
            batch = {k: torch.as_tensor(batch[k], device=dev)
                     for k in BATCH_KEYS if k in batch}

            # --- compute: every rank's gradients in the bucket layout
            with spans.span("bsp.compute"):
                loss, metrics, g_parts = (shares_grads if shares is not None
                                          else even_grads)(
                    state.params, leaves, flat_params, batch)

            # --- per bucket: EF → reduce-scatter → ZeRO-1 AdamW →
            # all-gather
            new_p_parts, om = [], {}
            with spans.span("bsp.sync"), torch.no_grad():
                for bkt, schedule, c, wc, s_len, s_off in zip(
                        engine.buckets, engine.schedules, bucket_codecs,
                        wire_codecs, shard_lens, shard_offs):
                    i = bkt.index
                    g = g_parts[i]
                    g_parts[i] = None         # drop it once reduced
                    if c is not None:
                        # EF-SGD, in place: corrected = g + res; the wire
                        # carries corrected - quantization_error(corrected)
                        # (one kernel launch on the card)
                        with spans.span("bsp.ef", bucket=i):
                            codec_ops.error_feedback_(
                                g, state.ef_residual[:, bkt.offset:
                                                     bkt.offset + bkt.length],
                                c)
                    with spans.span("bsp.reduce_scatter", bucket=i):
                        g_shard = engine.reduce_scatter_bucket(
                            g, schedule, codec=wc) / world
                        del g
                    with spans.span("bsp.zero1", bucket=i):
                        p_part = engine.pack_bucket(bkt, leaves, dtype=f32)
                        p_shard = p_part.view(world, s_len)[rev]
                        mu_b = state.flat_mu[:, s_off:s_off + s_len]
                        nu_b = state.flat_nu[:, s_off:s_off + s_len]
                        new_p, new_mu, new_nu, om = _adamw_flat(
                            p_shard, g_shard, mu_b, nu_b, state.step, acfg)
                        mu_b.copy_(new_mu)
                        nu_b.copy_(new_nu)
                        del p_part, p_shard, g_shard, new_mu, new_nu
                    # publish: the all-gather inverts the bit-reversed
                    # scatter; every rank's row is the same, keep one
                    with spans.span("bsp.all_gather", bucket=i):
                        new_p_parts.append(
                            engine.all_gather_bucket(new_p)[0].clone())
                        del new_p

                for leaf, new in zip(leaves,
                                     engine.unpack(new_p_parts, leaves)):
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
        return BSPTrainState(params, mu, nu, ef, 0, cfg)

    init_state.superstep_layout = layout_tag
    init_state.engine = engine
    return step_fn, init_state
