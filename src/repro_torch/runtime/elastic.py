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
surviving ranks, in the new world's order, instead of a device mesh.
``reshard_state`` places a restored state on a mesh's specs, which on one
card (``launch/mesh.py``: virtual devices on one torch device) means
checking each spec against the mesh and moving the state to the mesh's
device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterable, Optional, Sequence, Tuple

import torch

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


def reshard_state(state, mesh, spec_tree):
    """Re-place a (restored) host-side state onto ``mesh``: every tensor on
    the mesh's torch device, returned as a new tree.  ``spec_tree`` is a
    tree prefix of ``state`` whose leaves are specs (``models.sharding.P``;
    a spec where ``state`` has a subtree applies to all of it), as the
    reference's ``device_put`` takes it.  Raises ``ValueError`` where that
    raises: a tree that does not match, a spec that names an axis the mesh
    lacks or names one twice, one longer than its tensor's rank, or one
    whose axes do not divide their dimension; and for an abstract mesh,
    which has no device."""
    from repro_torch.models.sharding import P, check_spec
    if mesh.device is None:
        raise ValueError(f"{mesh!r} is abstract: it has no device to place "
                         "a state on")

    def place(x, spec):
        if not isinstance(x, torch.Tensor):
            return x
        check_spec(tuple(x.shape), mesh, spec)
        y = x.detach().to(mesh.device)
        return y.requires_grad_(True) if x.requires_grad else y

    def walk(x, spec, path):
        if isinstance(spec, P):
            return walk_leaves(x, spec)
        if isinstance(spec, dict):
            if not isinstance(x, dict) or set(x) != set(spec):
                raise ValueError(f"{path or 'state'}: spec keys "
                                 f"{sorted(spec)} do not match the state's")
            return {k: walk(x[k], spec[k], f"{path}/{k}") for k in x}
        if isinstance(spec, (list, tuple)):
            if not isinstance(x, (list, tuple)) or len(x) != len(spec):
                raise ValueError(f"{path or 'state'}: a spec sequence of "
                                 f"{len(spec)} for the state's "
                                 f"{type(x).__name__}")
            items = [walk(v, sp, f"{path}/{i}")
                     for i, (v, sp) in enumerate(zip(x, spec))]
            return type(x)(*items) if hasattr(x, "_fields") \
                else type(x)(items)
        raise ValueError(f"{path or 'state'}: {spec!r} is not a spec")

    def walk_leaves(x, spec):
        if isinstance(x, dict):
            return {k: walk_leaves(v, spec) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            items = [walk_leaves(v, spec) for v in x]
            return type(x)(*items) if hasattr(x, "_fields") \
                else type(x)(items)
        return place(x, spec)

    return walk(state, spec_tree, "")
