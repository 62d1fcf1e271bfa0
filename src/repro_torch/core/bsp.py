"""Bulk Synchronous Parallel configuration and gradient sync (port of
``repro/core/bsp.py``).

A BSP superstep is local compute → communication → global barrier.  On one
device the BSP world is the leading rank axis of every per-rank tensor
(see ``core/collectives.py``), so there is no ``shard_map`` to enter:
``sync_gradients`` takes rank-stacked gradients and returns them
synchronised.  The reference's ``bsp_shard_map`` has no counterpart.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

from . import collectives
from .cost_model import LinkParams


@dataclass(frozen=True)
class BSPConfig:
    """How a BSP step synchronizes (the reference's fields and checks).

    sync_axes   : names of the synchronization axes (one rank axis here).
    schedule    : gradient collective schedule (collectives.SCHEDULES), or
                  "auto" (the cost-model autotuner picks per bucket).
    compression : uniform payload codec ("none"|"bf16"|"int8").
    fsync_level : barrier scope (None = the whole world).
    pad_align   : each bucket is padded to a multiple of world × pad_align.
    bucket_mb   : ~MB per gradient bucket (reverse-layer order); None → one
                  bucket; "auto" → the DP bucket-boundary search against
                  the overlap-aware cost model.
    overlap     : False collapses bucketing back to one bucket.
    bucket_codec: per-bucket wire codec: None → the uniform ``compression``
                  (EF only, f32 wire); a name → that codec on the wire of
                  every fractal bucket (other schedules have no wire codec:
                  their buckets stay uncompressed); "auto" → the autotuner
                  picks a codec per bucket.
    link        : ``cost_model.LinkParams`` the autotuner prices with; None
                  → the reference's analytic ``TPU_V5E_ICI`` (a TPU's
                  parameter set: links fitted on the card are ROADMAP A13).
    """

    sync_axes: Tuple[str, ...] = ("data",)
    schedule: str = "fractal"
    compression: str = "none"
    fsync_level: Optional[int] = None
    pad_align: int = 128
    bucket_mb: Union[float, str, None] = None
    overlap: bool = True
    bucket_codec: Optional[str] = None
    link: Optional[LinkParams] = None

    def __post_init__(self):
        if self.schedule != "auto" and \
                self.schedule not in collectives.SCHEDULES:
            raise ValueError(f"unknown schedule {self.schedule!r}")
        if isinstance(self.bucket_mb, str):
            if self.bucket_mb != "auto":
                raise ValueError(f"bucket_mb must be a positive size in MB, "
                                 f"None, or 'auto'; got {self.bucket_mb!r}")
        elif self.bucket_mb is not None and self.bucket_mb <= 0:
            raise ValueError(f"bucket_mb must be positive, "
                             f"got {self.bucket_mb}")
        if self.bucket_codec not in (None, "auto", "none", "bf16", "int8"):
            raise ValueError(f"unknown bucket_codec {self.bucket_codec!r}")


def make_codec(name: Optional[str]):
    if name in (None, "none"):
        return None
    from repro_torch.optim.compression import Bf16Codec, Int8Codec
    if name == "bf16":
        return Bf16Codec()
    if name == "int8":
        return Int8Codec()
    raise ValueError(f"unknown compression {name!r}")


def resolve_schedule(cfg: BSPConfig, world: int,
                     payload_bytes: float) -> str:
    """Concrete schedule name for this config: "auto" → the autotuner's
    pick for ``world`` ranks (mesh shape ``(world,)``) and the payload,
    priced with ``cfg.link`` when one is given."""
    if cfg.schedule != "auto":
        return cfg.schedule
    from .autotune import pick_schedule
    if cfg.link is not None:
        return pick_schedule((world,), payload_bytes, link=cfg.link)
    return pick_schedule((world,), payload_bytes)


def sync_gradients(grads: Sequence, cfg: BSPConfig, world: int,
                   mean: bool = True):
    """All-reduce rank-stacked gradient leaves (each ``[W, *shape]``) with
    the configured schedule, bucketed by the SuperstepEngine; mean over
    the world by default.  Returns the leaves, rank-stacked."""
    if world == 1:
        return list(grads)
    from .superstep import engine_for
    return engine_for([g[0] for g in grads], cfg, world).sync(grads,
                                                              mean=mean)
