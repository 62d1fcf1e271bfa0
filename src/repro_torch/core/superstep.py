"""SuperstepEngine: bucketed BSP gradient synchronisation (port of
``repro/core/superstep.py``).

The gradient leaves, in the reference's ``jax.tree.leaves(params)`` order,
are partitioned into size-bounded buckets in reverse-layer order (bucket 0
holds the last layers), each padded to a multiple of world × pad_align.
Every consumer of the flat layout — packing, the ZeRO-1 shards, the EF
residual, the trainer's ``layout_tag`` — derives it from this one plan, so
equal leaf specs give the reference's buckets, offsets and shards exactly.

Each bucket gets its own schedule (and wire codec).  With
``schedule="auto"`` and/or ``bucket_codec="auto"`` the autotuner ranks
(schedule, codec) policies per bucket through the cost model
(``autotune.rank_policies``, ZeRO-1 publish pricing under ``zero1``);
``bucket_mb="auto"`` searches the bucket boundaries themselves
(``search_bucket_partition``: greedy candidates, then an exact dynamic
program over leaf prefix sums).  ``refined`` re-picks schedules from
measured timings, ``timeline`` prices the overlapped bucket pipeline.  The
cost model's link is ``cfg.link`` or the reference's analytic
``TPU_V5E_ICI`` (a TPU's parameter set, not the H100's), so equal leaf
specs give the reference's plan, picks and prices exactly.

Runtime methods work on tensors: ``pack``/``unpack`` convert between
leaves and per-bucket flat vectors; ``sync``, ``reduce_scatter_bucket``
and ``all_gather_bucket`` run the collectives on rank-stacked ``[W, L]``
bucket payloads.  A leaf handed to ``pack`` may be a tensor, or the list
of tensors whose flattened concatenation is the leaf (the port keeps one
tensor per layer where the reference stacks layers, see
``weights.reference_leaves``).
"""

from __future__ import annotations

import copy
import functools
import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from . import autotune
from . import collectives as C
from . import schedule_ir
from .bsp import BSPConfig, make_codec
from .cost_model import (LinkParams, OverlapTimeline, TPU_V5E_ICI,
                         overlap_step_cost)


def dtype_name(dtype: torch.dtype) -> str:
    """'float32', 'bfloat16', ... (the reference's ``jnp.dtype().name``)."""
    return str(dtype).removeprefix("torch.")


@dataclass(frozen=True)
class LeafSpec:
    """Shape and dtype name of one gradient (or parameter) leaf."""

    shape: Tuple[int, ...]
    dtype: str

    @property
    def size(self) -> int:
        return int(math.prod(self.shape))


@dataclass(frozen=True)
class Bucket:
    """One size-bounded slice of the bucket-ordered flat payload.

    ``leaf_ids`` index the original leaf list (reverse-layer order inside
    the bucket); ``offset``/``length`` locate the bucket's padded segment in
    the bucket-ordered flat vector (elements)."""

    index: int
    leaf_ids: Tuple[int, ...]
    raw: int                      # unpadded element count
    offset: int                   # start in the bucket-ordered flat vector
    length: int                   # padded element count (divides by world)

    def meta(self, n_buckets: int,
             codec: Optional[str] = None) -> schedule_ir.BucketMeta:
        return schedule_ir.BucketMeta(index=self.index, n_buckets=n_buckets,
                                      offset_elems=self.offset,
                                      length_elems=self.length,
                                      codec=codec)


def partition_buckets(leaf_sizes: Sequence[int], order: Sequence[int],
                      bucket_elems: Optional[int], pad_unit: int
                      ) -> Tuple[Bucket, ...]:
    """Greedy size-bounded partition of leaves (in ``order``) into buckets.

    A bucket closes before a leaf that would take it past
    ``bucket_elems`` raw elements (None → one bucket holds everything); a
    leaf larger than the bound gets its own bucket.  Every bucket is padded
    up to a multiple of ``pad_unit``."""
    groups: List[List[int]] = []
    cur: List[int] = []
    cur_elems = 0
    for i in order:
        if cur and bucket_elems is not None and \
                cur_elems + leaf_sizes[i] > bucket_elems:
            groups.append(cur)
            cur, cur_elems = [], 0
        cur.append(i)
        cur_elems += leaf_sizes[i]
    if cur:
        groups.append(cur)
    buckets: List[Bucket] = []
    offset = 0
    for bi, ids in enumerate(groups):
        raw = sum(leaf_sizes[i] for i in ids)
        length = ((raw + pad_unit - 1) // pad_unit) * pad_unit
        buckets.append(Bucket(index=bi, leaf_ids=tuple(ids), raw=raw,
                              offset=offset, length=length))
        offset += length
    return tuple(buckets)


# ---------------------------------------------------------------------------
# DP bucket-boundary search (BSPConfig(bucket_mb="auto"))
# ---------------------------------------------------------------------------
#
# A fixed ``bucket_mb`` is one point on a curve: small buckets start
# communication early but pay per-collective latency and padding; big
# buckets amortize both but idle the fabric while backward still computes.
# The overlapped finish time of a partition follows the shared-fabric
# recurrence
#
#     finish_k = max(finish_{k-1}, ready_k) + cost(bytes_k)
#
# which is monotone in finish_{k-1} — so the minimal finish over all
# boundary placements decomposes over prefixes and an O(n²) dynamic program
# over leaf prefix sums finds the EXACT optimum.  The greedy
# packer supplies the initial upper bound (branch pruning) and remains the
# fallback if float noise ever puts the DP above it.


@dataclass(frozen=True)
class PartitionPlan:
    """A searched bucket partition plus the objective it was chosen by."""

    buckets: Tuple[Bucket, ...]
    objective_s: float            # overlapped finish time under cost_fn
    source: str                   # "dp" | "greedy:<mb>MB"
    backward_s: float             # the backward duration the search assumed


GREEDY_FALLBACK_MBS = (4.0, 16.0, 64.0, 256.0)


def partition_objective(buckets: Sequence[Bucket],
                        cost_of_bytes: Callable[[float], float],
                        itemsize: int, backward_s: float) -> float:
    """Overlapped finish time of a partition on the shared-fabric timeline:
    bucket k enters the fabric at max(fabric-free, ready_k) — the same
    recurrence ``cost_model.overlap_step_cost`` prices, with per-bucket
    costs delegated to ``cost_of_bytes(padded bytes)``."""
    total_raw = max(1, sum(b.raw for b in buckets))
    fabric, cum = 0.0, 0
    for b in buckets:
        cum += b.raw
        ready = backward_s * cum / total_raw
        fabric = max(fabric, ready) + cost_of_bytes(b.length * itemsize)
    return fabric


def dp_partition(leaf_sizes: Sequence[int], order: Sequence[int],
                 pad_unit: int, itemsize: int,
                 cost_of_bytes: Callable[[float], float],
                 backward_s: float,
                 upper_bound: float = math.inf) -> Tuple[Bucket, ...]:
    """Optimal contiguous partition of ``order``-ed leaves into buckets,
    minimizing ``partition_objective``.

    ``f[i]`` = minimal fabric-free time after syncing the first ``i`` leaves;
    ``f[i] = min_j max(f[j], ready_i) + cost(bytes(j..i))``.  States already
    at or above ``upper_bound`` (the greedy packer's objective) are pruned —
    they cannot lead to a better plan since costs are nonnegative.
    """
    sizes_o = [leaf_sizes[i] for i in order]
    n = len(sizes_o)
    prefix = [0] * (n + 1)
    for i, s in enumerate(sizes_o):
        prefix[i + 1] = prefix[i] + s
    total_raw = max(1, prefix[n])

    def padded(raw: int) -> int:
        return ((raw + pad_unit - 1) // pad_unit) * pad_unit

    f = [math.inf] * (n + 1)
    f[0] = 0.0
    parent = [0] * (n + 1)
    for i in range(1, n + 1):
        ready = backward_s * prefix[i] / total_raw
        best, arg = math.inf, 0
        for j in range(i):
            if f[j] >= upper_bound or f[j] >= best:
                continue
            c = cost_of_bytes(padded(prefix[i] - prefix[j]) * itemsize)
            v = max(f[j], ready) + c
            if v < best:
                best, arg = v, j
        f[i], parent[i] = best, arg

    bounds: List[Tuple[int, int]] = []
    i = n
    while i > 0:
        bounds.append((parent[i], i))
        i = parent[i]
    bounds.reverse()
    buckets: List[Bucket] = []
    offset = 0
    for bi, (j, i) in enumerate(bounds):
        ids = tuple(order[j:i])
        raw = prefix[i] - prefix[j]
        length = padded(raw)
        buckets.append(Bucket(index=bi, leaf_ids=ids, raw=raw,
                              offset=offset, length=length))
        offset += length
    return tuple(buckets)


def search_bucket_partition(leaf_sizes: Sequence[int], order: Sequence[int],
                            pad_unit: int, itemsize: int,
                            cost_of_bytes: Callable[[float], float],
                            backward_s: Optional[float] = None,
                            greedy_mbs: Sequence[float] = GREEDY_FALLBACK_MBS
                            ) -> PartitionPlan:
    """Greedy candidates for the upper bound, then the DP for the optimum.

    ``backward_s`` is the assumed backward-pass duration the ready times
    scale against; None defaults to the cost of one monolithic collective
    over the whole payload — the balanced compute≈comm regime where bucket
    boundaries matter most (a workload-measured value refines it).
    """
    total = sum(leaf_sizes)
    total_padded = ((total + pad_unit - 1) // pad_unit) * pad_unit
    if backward_s is None:
        backward_s = cost_of_bytes(total_padded * itemsize)
    best: Optional[PartitionPlan] = None
    for mb in greedy_mbs:
        elems = max(1, int(mb * 1e6 / itemsize))
        g = partition_buckets(leaf_sizes, order, elems, pad_unit)
        obj = partition_objective(g, cost_of_bytes, itemsize, backward_s)
        if best is None or obj < best.objective_s:
            best = PartitionPlan(g, obj, f"greedy:{mb:g}MB", backward_s)
    dp = dp_partition(leaf_sizes, order, pad_unit, itemsize, cost_of_bytes,
                      backward_s, upper_bound=best.objective_s)
    dp_obj = partition_objective(dp, cost_of_bytes, itemsize, backward_s)
    if dp_obj <= best.objective_s:
        return PartitionPlan(dp, dp_obj, "dp", backward_s)
    return best


def _segments(leaf) -> List[torch.Tensor]:
    """The tensors whose flattened concatenation is ``leaf``."""
    if isinstance(leaf, torch.Tensor):
        return [leaf]
    return list(getattr(leaf, "parts", leaf))


class SuperstepEngine:
    """Bucket plan for one (leaf structure, world, config) + its runtime
    lowering on rank-stacked tensors.

    ``world`` is the rank count; the cost model sees the mesh shape
    ``(world,)``, the train CLI's one ``"data"`` axis.  ``zero1`` prices
    the trainer's
    lowering (reduce-scatter + shard update + publish all-gather) instead
    of a bare all-reduce; ``backward_s`` is the DP search's backward hint.
    """

    def __init__(self, leaf_specs: Sequence[LeafSpec], cfg: BSPConfig,
                 world: int, zero1: bool = False,
                 backward_s: Optional[float] = None):
        self.cfg = cfg
        self.sizes = (world,)
        self.world = world
        self.leaf_specs = tuple(leaf_specs)
        self.zero1 = zero1
        # the link the tuner prices with: the config's (fitted) params, or
        # the reference's analytic TPU defaults
        self.link = cfg.link if cfg.link is not None else TPU_V5E_ICI
        self.backward_s_hint = backward_s
        leaf_sizes = [s.size for s in self.leaf_specs]
        order = tuple(reversed(range(len(self.leaf_specs))))
        pad_unit = max(1, self.world) * cfg.pad_align
        self.flat_dtype = self._flat_dtype()
        self.flat_itemsize = self.flat_dtype.itemsize

        auto_codec = cfg.bucket_codec == "auto"
        # int8's per-128-block scales need 128-aligned wire payloads
        codec_candidates = ("none", "bf16") + \
            (("int8",) if cfg.pad_align % 128 == 0 else ())
        if cfg.schedule == "auto":
            sched_candidates = None
        elif cfg.schedule == "xla":
            sched_candidates = ("fractal",)    # price the sum as butterfly
        else:
            sched_candidates = (cfg.schedule,)

        def policy_rank(payload_bytes: float):
            return autotune.rank_policies(
                self.sizes, payload_bytes, link=self.link,
                schedules=sched_candidates,
                codecs=codec_candidates if auto_codec else ("none",),
                zero1_publish=zero1)

        self.plan: Optional[PartitionPlan] = None
        if cfg.overlap and cfg.bucket_mb == "auto":
            self.plan = search_bucket_partition(
                leaf_sizes, order, pad_unit, self.flat_itemsize,
                cost_of_bytes=lambda by: policy_rank(by)[0].predicted_s,
                backward_s=backward_s)
            self.buckets = self.plan.buckets
        else:
            bucket_elems = None
            if cfg.bucket_mb is not None and cfg.overlap:
                bucket_elems = max(1, int(cfg.bucket_mb * 1e6
                                          / self.flat_itemsize))
            self.buckets = partition_buckets(leaf_sizes, order, bucket_elems,
                                             pad_unit)
        self.total_padded = sum(b.length for b in self.buckets)

        bucket_bytes = [b.length * self.flat_itemsize for b in self.buckets]
        if cfg.schedule == "xla" or \
                (cfg.schedule != "auto" and not auto_codec):
            self.schedules = (cfg.schedule,) * len(self.buckets)
            self.codec_names = self._uniform_codec_names()
        else:
            policies = [policy_rank(by)[0] for by in bucket_bytes]
            self.schedules = tuple(p.schedule for p in policies)
            self.codec_names = tuple(p.codec for p in policies) \
                if auto_codec else self._uniform_codec_names()
        if cfg.bucket_codec is not None:
            # only the fractal lowering carries a wire codec: a forced codec
            # on another schedule would be inert on the wire yet still cost
            # EF quantization in the trainer, so it is normalized away per
            # bucket (the uniform `compression` keeps its EF-always meaning)
            self.codec_names = tuple(
                c if s == "fractal" else "none"
                for s, c in zip(self.schedules, self.codec_names))
        self.bucket_codecs = tuple(make_codec(n) for n in self.codec_names)

    @property
    def link_name(self) -> str:
        return self.link.name

    def _uniform_codec_names(self) -> Tuple[str, ...]:
        name = self.cfg.bucket_codec \
            if self.cfg.bucket_codec not in (None, "auto") \
            else (self.cfg.compression or "none")
        return (name,) * len(self.buckets)

    def refined(self, measure: Callable[[str, float], float],
                measure_budget: int,
                measure_top_k: int = 2) -> "SuperstepEngine":
        """Measured refinement of the per-bucket schedule picks.

        Spends up to ``measure_budget`` calls of ``measure(schedule,
        payload_bytes) → seconds`` re-picking the analytic winners,
        priciest buckets first (``autotune.pick_bucket_schedules``), and
        returns a shallow copy with the refined picks.  Buckets the budget
        never reaches keep their picks; a bucket whose schedule changes
        keeps its codec only if the new schedule is the fractal one (the
        only wire-codec lowering).  A forced schedule has nothing to
        re-pick: the engine comes back unchanged.
        """
        if self.cfg.schedule != "auto":
            return copy.copy(self)
        names = autotune.pick_bucket_schedules(
            self.sizes,
            [b.length * self.flat_itemsize for b in self.buckets],
            link=self.link, zero1_publish=self.zero1, measure=measure,
            measure_budget=measure_budget, measure_top_k=measure_top_k,
            baseline=self.schedules)
        eng = copy.copy(self)
        eng.schedules = tuple(names)
        eng.codec_names = tuple(
            c if new == "fractal" else "none"
            for new, c in zip(names, self.codec_names))
        eng.bucket_codecs = tuple(make_codec(n) for n in eng.codec_names)
        return eng

    # -- plan inspection ----------------------------------------------------

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    def shard_len(self, bucket: Bucket) -> int:
        return bucket.length // self.world

    def shard_offsets(self) -> Tuple[int, ...]:
        """Per-bucket start of a rank's shard in its moment vector (the
        bucket-ordered concatenation of per-bucket shards)."""
        out, acc = [], 0
        for b in self.buckets:
            out.append(acc)
            acc += self.shard_len(b)
        return tuple(out)

    def programs(self) -> Tuple[schedule_ir.Program, ...]:
        """Bucket-tagged IR programs (one per bucket; "xla" has none)."""
        out = []
        for b, name, codec in zip(self.buckets, self.schedules,
                                  self.codec_names):
            if name == "xla":
                raise ValueError("'xla' buckets have no IR program")
            prog = schedule_ir.build_program(name, self.sizes)
            meta = b.meta(self.n_buckets,
                          codec=None if codec == "none" else codec)
            out.append(prog.with_bucket(meta))
        return tuple(out)

    def describe(self) -> str:
        bs = self.flat_itemsize
        parts = ", ".join(
            f"b{b.index}:{b.length * bs / 1e6:.1f}MB→{s}"
            + ("" if c == "none" else f"+{c}")
            for b, s, c in zip(self.buckets, self.schedules,
                               self.codec_names))
        src = f" [{self.plan.source}]" if self.plan is not None else ""
        return (f"{self.n_buckets} bucket(s) over world {self.world} "
                f"({self.total_padded * bs / 1e6:.1f}MB padded){src}: "
                f"{parts}")

    def timeline(self, backward_s: float,
                 link: Optional[LinkParams] = None,
                 outer_link: Optional[LinkParams] = None,
                 mesh_contention: bool = True) -> OverlapTimeline:
        """Overlap-aware predicted step time for a given backward duration.

        Bucket i (reverse-layer) becomes ready once backward has produced
        its slice of the gradients: ready_i = backward_s × (cumulative
        parameter fraction through bucket i).  ``link=None`` prices with
        the engine's own link.  Per-bucket codecs shrink the priced wire
        volume by their wire-bytes ratio and pay their launch overhead, the
        same terms ``autotune.rank_policies`` chose them by.
        """
        alphas = autotune.codec_step_alphas()
        link = link if link is not None else self.link
        total_raw = max(1, sum(b.raw for b in self.buckets))
        ready, cum = [], 0
        for b in self.buckets:
            cum += b.raw
            ready.append(backward_s * cum / total_raw)
        vols = [float(b.length * self.flat_itemsize)
                * autotune.CODEC_WIRE_RATIO.get(c, 1.0)
                for b, c in zip(self.buckets, self.codec_names)]
        progs = self.programs()
        extra = [alphas.get(c, 0.0) * link.alpha_s * p.num_steps
                 for c, p in zip(self.codec_names, progs)]
        return overlap_step_cost(progs, vols, ready, link,
                                 outer_link, mesh_contention, extra_s=extra)

    # -- runtime lowering ---------------------------------------------------

    def _flat_dtype(self) -> torch.dtype:
        if not self.leaf_specs:
            return torch.float32
        return functools.reduce(torch.promote_types,
                                [getattr(torch, s.dtype)
                                 for s in self.leaf_specs])

    def pack_bucket(self, bucket: Bucket, leaves: Sequence[Any], dtype=None,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One bucket's leaves → its padded flat vector ``[length]``
        (written into ``out``, a zero-padded buffer, when given)."""
        segs = [t for i in bucket.leaf_ids for t in _segments(leaves[i])]
        flat = out if out is not None else torch.zeros(
            bucket.length, dtype=dtype or self.flat_dtype,
            device=segs[0].device)
        off = 0
        for t in segs:
            n = t.numel()
            flat[off:off + n].copy_(t.reshape(-1))
            off += n
        if off != bucket.raw:
            raise ValueError(f"bucket {bucket.index}: leaves hold {off} "
                             f"elements, the plan {bucket.raw}")
        return flat

    def pack(self, leaves: Sequence[Any], dtype=None,
             out: Optional[Sequence[torch.Tensor]] = None
             ) -> List[torch.Tensor]:
        """Leaves → per-bucket padded flat vectors ``[length]``.

        With ``out`` (one zero-padded ``[length]`` buffer per bucket, e.g.
        one rank's row of a rank-stacked payload) the leaves are written
        there instead of into new buffers."""
        return [self.pack_bucket(b, leaves, dtype,
                                 None if out is None else out[b.index])
                for b in self.buckets]

    def unpack(self, parts: Sequence[torch.Tensor],
               like_leaves: Sequence[Any]) -> List[torch.Tensor]:
        """Per-bucket flat vectors ``[..., length]`` → leaves ``[...,
        *shape]`` (original order, the dtypes of ``like_leaves``)."""
        out: List[Optional[torch.Tensor]] = [None] * len(self.leaf_specs)
        for b, part in zip(self.buckets, parts):
            lead = tuple(part.shape[:-1])
            off = 0
            for i in b.leaf_ids:
                spec = self.leaf_specs[i]
                seg = part[..., off:off + spec.size]
                out[i] = seg.reshape(lead + spec.shape).to(
                    like_leaves[i].dtype)
                off += spec.size
        return out  # type: ignore[return-value]

    def _bucket_all_reduce(self, part: torch.Tensor, schedule: str,
                           codec=None) -> torch.Tensor:
        if schedule == "fractal":
            return C.fractal_all_reduce(part, codec=codec)
        return C.all_reduce(part, schedule, self.sizes)

    def sync(self, grads: Sequence[torch.Tensor], mean: bool = True
             ) -> List[torch.Tensor]:
        """Bucketed all-reduce of rank-stacked gradient leaves (each
        ``[W, *shape]``); each bucket rides its own codec."""
        if self.world == 1:
            return list(grads)
        W = self.world
        dev = grads[0].device
        rows = [torch.zeros(W, b.length, dtype=self.flat_dtype, device=dev)
                for b in self.buckets]
        for r in range(W):
            self.pack([g[r] for g in grads], out=[p[r] for p in rows])
        out_parts = []
        for schedule, codec, part in zip(self.schedules, self.bucket_codecs,
                                         rows):
            red = self._bucket_all_reduce(part, schedule, codec)
            if mean:
                red = red / W
            out_parts.append(red)
        return self.unpack(out_parts, grads)

    def reduce_scatter_bucket(self, part: torch.Tensor, schedule: str,
                              codec=None) -> torch.Tensor:
        """Sum-reduce-scatter of one rank-stacked bucket ``[W, length]`` →
        ``[W, length / W]`` (ZeRO-1 grad shards); ``codec``
        wire-compresses the fractal halving exchanges."""
        return C.reduce_scatter(part, schedule, codec=codec,
                                shape=self.sizes)

    def all_gather_bucket(self, shard: torch.Tensor) -> torch.Tensor:
        """Gather updated per-rank shards ``[W, length / W]`` back into
        bucket flat order, on every rank: ``[W, length]``."""
        return C.all_gather_flat(shard)


def leaf_specs_of(leaves: Sequence[Any], force_dtype=None
                  ) -> Tuple[LeafSpec, ...]:
    """LeafSpecs of tensors (or anything with ``.shape`` and ``.dtype``)."""
    return tuple(LeafSpec(shape=tuple(l.shape),
                          dtype=dtype_name(force_dtype or l.dtype))
                 for l in leaves)


@lru_cache(maxsize=64)
def _cached_engine(leaf_specs: Tuple[LeafSpec, ...], cfg: BSPConfig,
                   world: int, zero1: bool,
                   backward_s: Optional[float]) -> SuperstepEngine:
    return SuperstepEngine(leaf_specs, cfg, world, zero1=zero1,
                           backward_s=backward_s)


def engine_for(leaves: Sequence[Any], cfg: BSPConfig, world: int,
               force_dtype=None, zero1: bool = False,
               backward_s: Optional[float] = None) -> SuperstepEngine:
    """The (cached) engine for this leaf structure: the plan depends only
    on leaf shapes and dtypes, the config, the world, the zero1 pricing
    mode and the DP search's backward hint."""
    return _cached_engine(leaf_specs_of(leaves, force_dtype), cfg, world,
                          zero1, backward_s)
