"""Elastic re-meshing: resume on the largest surviving fsync domain (port
of ``repro/runtime/elastic.py``).

Recovery flow:

  1. ``HostMonitor`` reports failed hosts → failed mesh tiles.
  2. ``surviving_domain`` (fault_tolerance) picks the largest complete
     synchronization subtree with no failed member — the paper's fsync
     domains make this a *structural* choice, not an ad-hoc one: the domain
     is exactly a node of the H-tree, so the surviving collective schedule
     is the same fractal schedule at a lower level.
  3. The new world is the survivors in tile order (``surviving_ranks``);
     parameters are restored from the latest checkpoint; the data pipeline
     is re-sharded (global batch preserved by raising per-rank
     accumulation).

On one device the BSP ranks are the leading axis of every per-rank tensor
(``core/collectives.py``), so the re-mesh is a smaller rank axis: the
counterpart of the reference's ``build_mesh_from_tiles`` returns the
surviving ranks, in the new world's order, instead of a device mesh.  The
reference's ``reshard_state`` places a restored state onto GSPMD
shardings; it comes with the sharding surface (ROADMAP A12).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterable, Optional, Sequence, Tuple

from repro_torch.core.tree import FractalTree
from repro_torch.runtime.fault_tolerance import surviving_domain

Coord = Tuple[int, ...]


@dataclass(frozen=True)
class ElasticPlan:
    level: int                    # fsync level of the surviving domain
    tiles: Tuple[Coord, ...]      # surviving mesh coordinates
    mesh_shape: Tuple[int, ...]
    grad_accum_scale: int         # × gradient accumulation to keep batch

    @property
    def world(self) -> int:
        return len(self.tiles)


def plan_recovery(tree: FractalTree, failed: Iterable[Coord],
                  old_world: Optional[int] = None) -> ElasticPlan:
    level, tiles = surviving_domain(tree, failed)
    world = len(tiles)
    old_world = old_world or tree.num_tiles
    # keep global batch: each survivor takes old_world/world × the work
    scale = max(1, old_world // max(world, 1))
    # shape the new mesh as square-ish powers of two (data × model kept by
    # caller; here we only report the domain geometry)
    rows = 1 << (int(math.log2(world)) // 2)
    cols = world // rows
    return ElasticPlan(level=level, tiles=tiles, mesh_shape=(rows, cols),
                       grad_accum_scale=scale)


def surviving_ranks(tree: FractalTree, tiles: Sequence[Coord]
                    ) -> Tuple[int, ...]:
    """The old world's flat (row-major) rank of each surviving tile, in
    tile order: new rank i is old rank ``surviving_ranks(...)[i]``, as the
    reference's ``build_mesh_from_tiles`` orders its devices."""
    out = []
    for t in tiles:
        tree._check_tile(t)
        flat = 0
        for c, d in zip(t, tree.shape):
            flat = flat * d + c
        out.append(flat)
    return tuple(out)
