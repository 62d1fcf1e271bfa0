"""SuperstepEngine: bucketed BSP gradient synchronisation (port of
``repro/core/superstep.py``).

The gradient leaves, in the reference's ``jax.tree.leaves(params)`` order,
are partitioned into size-bounded buckets in reverse-layer order (bucket 0
holds the last layers), each padded to a multiple of world × pad_align.
Every consumer of the flat layout — packing, the ZeRO-1 shards, the EF
residual, the trainer's ``layout_tag`` — derives it from this one plan, so
equal leaf specs give the reference's buckets, offsets and shards exactly.

Ported: the fractal schedule (the only one the port lowers), a fixed
codec, a numeric or absent ``bucket_mb``.  The cost-model half of the
reference (``schedule="auto"``,
``bucket_mb="auto"``, ``bucket_codec="auto"``, ``refined``, ``timeline``,
fitted links) needs ``core.cost_model``/``core.autotune`` (ROADMAP A3) and
raises.

Runtime methods work on tensors: ``pack``/``unpack`` convert between
leaves and per-bucket flat vectors; ``sync``, ``reduce_scatter_bucket``
and ``all_gather_bucket`` run the collectives on rank-stacked ``[W, L]``
bucket payloads.  A leaf handed to ``pack`` may be a tensor, or the list
of tensors whose flattened concatenation is the leaf (the port keeps one
tensor per layer where the reference stacks layers, see
``weights.reference_leaves``).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Any, List, Optional, Sequence, Tuple

import torch

from . import collectives as C
from .bsp import BSPConfig, make_codec

# the reference's default cost-model link (core/cost_model.TPU_V5E_ICI);
# only its name is needed until the cost model is ported
DEFAULT_LINK_NAME = "v5e-ici"


def _auto_missing(what: str):
    return NotImplementedError(
        f"{what} needs the cost model and autotuner (ROADMAP A3), not "
        "ported yet")


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


def _segments(leaf) -> List[torch.Tensor]:
    """The tensors whose flattened concatenation is ``leaf``."""
    if isinstance(leaf, torch.Tensor):
        return [leaf]
    return list(getattr(leaf, "parts", leaf))


class SuperstepEngine:
    """Bucket plan for one (leaf structure, world, config) + its runtime
    lowering on rank-stacked tensors."""

    def __init__(self, leaf_specs: Sequence[LeafSpec], cfg: BSPConfig,
                 world: int):
        if cfg.schedule == "auto":
            raise _auto_missing("schedule='auto'")
        if cfg.bucket_mb == "auto" and cfg.overlap:
            raise _auto_missing("bucket_mb='auto'")
        if cfg.bucket_codec == "auto":
            raise _auto_missing("bucket_codec='auto'")
        if cfg.link is not None:
            raise _auto_missing("fitted link parameters")
        C.check_schedule(cfg.schedule)
        self.cfg = cfg
        self.world = world
        self.leaf_specs = tuple(leaf_specs)
        self.link_name = DEFAULT_LINK_NAME
        leaf_sizes = [s.size for s in self.leaf_specs]
        order = tuple(reversed(range(len(self.leaf_specs))))
        pad_unit = max(1, world) * cfg.pad_align
        self.flat_dtype = self._flat_dtype()
        self.flat_itemsize = self.flat_dtype.itemsize
        bucket_elems = None
        if cfg.bucket_mb is not None and cfg.overlap:
            bucket_elems = max(1, int(cfg.bucket_mb * 1e6
                                      / self.flat_itemsize))
        self.buckets = partition_buckets(leaf_sizes, order, bucket_elems,
                                         pad_unit)
        self.total_padded = sum(b.length for b in self.buckets)
        self.schedules = (cfg.schedule,) * len(self.buckets)
        name = cfg.bucket_codec if cfg.bucket_codec is not None \
            else (cfg.compression or "none")
        self.codec_names = (name,) * len(self.buckets)
        self.bucket_codecs = tuple(make_codec(n) for n in self.codec_names)

    def refined(self, *args, **kwargs):
        raise _auto_missing("SuperstepEngine.refined")

    def timeline(self, *args, **kwargs):
        raise _auto_missing("SuperstepEngine.timeline")

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

    def describe(self) -> str:
        bs = self.flat_itemsize
        parts = ", ".join(
            f"b{b.index}:{b.length * bs / 1e6:.1f}MB→{s}"
            + ("" if c == "none" else f"+{c}")
            for b, s, c in zip(self.buckets, self.schedules,
                               self.codec_names))
        return (f"{self.n_buckets} bucket(s) over world {self.world} "
                f"({self.total_padded * bs / 1e6:.1f}MB padded): {parts}")

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
        for codec, part in zip(self.bucket_codecs, rows):
            red = C.fractal_all_reduce(part, codec=codec)
            if mean:
                red = red / W
            out_parts.append(red)
        return self.unpack(out_parts, grads)

    def reduce_scatter_bucket(self, part: torch.Tensor, schedule: str,
                              codec=None) -> torch.Tensor:
        """Sum-reduce-scatter of one rank-stacked bucket ``[W, length]`` →
        ``[W, length / W]`` (ZeRO-1 grad shards); ``codec``
        wire-compresses the fractal halving exchanges."""
        return C.reduce_scatter(part, schedule, codec=codec)

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
                   world: int) -> SuperstepEngine:
    return SuperstepEngine(leaf_specs, cfg, world)


def engine_for(leaves: Sequence[Any], cfg: BSPConfig, world: int,
               force_dtype=None) -> SuperstepEngine:
    """The (cached) engine for this leaf structure: the plan depends only
    on leaf shapes and dtypes, the config and the world."""
    return _cached_engine(leaf_specs_of(leaves, force_dtype), cfg, world)
