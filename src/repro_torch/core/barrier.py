"""fsync(level): programmable synchronization domains (paper §3.2; port of
``repro/core/barrier.py``).

The paper extends the tile ISA with a single instruction, ``fsync(level)``:
synchronize with every PE under the level-``level`` node of the
synchronization tree.  Disjoint subtrees (synchronization domains) proceed
independently; a level mismatch between neighbors raises the FS module's
*error* signal.

On one device the BSP world is the rank axis of a stacked tensor:

  * ``SyncDomainMesh`` holds the mesh ``sizes`` of the synchronization axes
    (outermost first) and the ``FractalTree`` over them, and resolves a
    *level* to its domain size.
  * ``fsync(level)``: the recursive-doubling token barrier over the domain
    (``collectives.fractal_barrier``); every rank's token == domain size.
  * Level-mismatch detection is a host-side check: ``SyncScope`` records the
    level each superstep requests per domain and raises ``FSyncError`` on
    conflicting concurrent levels (the paper's *error* wire).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch

from .collectives import fractal_barrier
from .tree import FractalTree


class FSyncError(RuntimeError):
    """Synchronization-level mismatch (paper: the FS module's *error* signal)."""


@dataclass(frozen=True)
class SyncDomainMesh:
    """The synchronization axes of a BSP world with their H-tree hierarchy.

    ``sizes`` are the axis sizes ordered outermost-first (e.g. ``(2, 4)``
    for ``("pod", "data")``); the flattened product forms the tree's leaves
    with the innermost axis merging first (neighbors first, pods last).
    """

    sizes: Tuple[int, ...]
    sync_axes: Tuple[str, ...] = ("data",)

    @property
    def world(self) -> int:
        return math.prod(self.sizes)

    @property
    def tree(self) -> FractalTree:
        return FractalTree(self.sizes)

    @property
    def num_levels(self) -> int:
        return self.tree.num_levels

    def domain_size(self, level: Optional[int] = None) -> int:
        level = self.num_levels if level is None else level
        return 1 << level

    def fsync(self, level: Optional[int] = None, token=None,
              device=None) -> torch.Tensor:
        """Issue the barrier: every rank's token ``[W]`` (== the size of its
        domain)."""
        return fractal_barrier(self.world, level=level, token=token,
                               device=device)


def barrier_tie(x: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    """``x``, ordered after the barrier ``token``, value unchanged.

    The reference wraps both in ``lax.optimization_barrier`` so XLA cannot
    move work across the superstep boundary of a compiled program.  Eager
    PyTorch runs every op in stream order, so the work after the barrier
    already follows it and there is nothing to tie: this is the identity."""
    del token
    return x


@dataclass
class SyncScope:
    """Host-side bookkeeping of concurrently-active fsync levels.

    The paper's FS module flags an *error* when its two slave ports request
    different levels.  A runtime composing per-domain programs can request
    conflicting levels; this scope performs the equivalent check when
    supersteps are scheduled.
    """

    mesh: SyncDomainMesh
    active: Dict[Tuple[int, ...], int] = field(default_factory=dict)

    def request(self, domain_key: Tuple[int, ...], level: int) -> None:
        tree = self.mesh.tree
        if not 0 <= level <= tree.num_levels:
            raise FSyncError(f"level {level} outside 0..{tree.num_levels}")
        for other_key, other_level in self.active.items():
            # two concurrent requests conflict if one domain contains the
            # other but the levels disagree (mismatched subtree roots)
            lo, hi = sorted((level, other_level))
            a, b = (domain_key, other_key) if level <= other_level \
                else (other_key, domain_key)
            # project the smaller domain's key up to the larger level
            if tree.domain_key(a, hi) == b and lo != hi:
                raise FSyncError(
                    f"fsync level mismatch: domain {domain_key} at level "
                    f"{level} vs domain {other_key} at level {other_level}")
        self.active[domain_key] = level

    def complete(self, domain_key: Tuple[int, ...]) -> None:
        self.active.pop(domain_key, None)
