"""FractalSync synchronization tree (paper §3.1-§3.2); the port's copy of
``repro/core/tree.py``, unchanged in behaviour.

The paper synchronizes a k×k tile mesh with a binary tree of FractalSync (FS)
modules laid out as an H-tree: level 1 synchronizes pairs of neighboring tiles,
level 2 synchronizes pairs of level-1 FS modules, ..., level L = log2(N) is the
root.  ``fsync(level)`` synchronizes the subtree rooted at ``level`` — a
*synchronization domain*.

This module is the pure-Python topological model shared by

  * the cycle-accurate simulator (``core/simulator.py``) — Table 1 reproduction,
  * the rank-stacked collective schedules (``core/collectives.py``) — the
    butterfly / recursive halving-doubling generalization of the H-tree
    recursion,
  * the area model (``core/area.py``) — N-1 FS modules for N tiles.

Geometry/pipelining model (paper §4.1, FractalSync+Pipeline): the level-l FS
module sits midway between its two children, so the child→parent wire spans half
the child separation.  Wires longer than one NoC tile pitch are segmented with
pipeline registers so that no segment exceeds the distance between two
neighboring NoC nodes.  With child separation ``sep(l) = 2^((l-1)//2)`` tile
pitches (axes alternate per level — the H-tree recursion), the register count is
``max(0, sep(l)//2 - 1)``.  This reproduces Table 1 exactly:

  mesh      levels  FSync = 2+2L   FSync+P = 2+2·Σ(1+regs)
  Neighbor  1       4              4
  2×2       2       6              6
  4×4       4       10             10
  8×8       6       14             14+2·(1+1)        = 18
  16×16     8       18             18+2·(1+1+3+3)    = 34
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import cached_property
from typing import Iterator, Sequence, Tuple

Coord = Tuple[int, ...]


def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


@dataclass(frozen=True)
class LevelSpec:
    """One level of the synchronization tree.

    axis : mesh axis whose coordinate bit is merged at this level
    bit  : which bit of that coordinate (0 = LSB)
    separation : distance (tile pitches) between the centers of the two child
                 groups merged at this level
    """

    level: int
    axis: int
    bit: int
    separation: int

    @property
    def wire_pitches(self) -> float:
        """Child→parent wire length: half the child-center separation."""
        return self.separation / 2

    @property
    def pipeline_regs(self) -> int:
        """Registers needed so no wire segment exceeds one NoC pitch."""
        return max(0, self.separation // 2 - 1)


@dataclass(frozen=True)
class FractalTree:
    """Binary synchronization tree over a power-of-two mesh.

    ``shape`` is the mesh shape, e.g. (16, 16) for the paper's largest config,
    (1, 2) for the paper's *Neighbor* case, or (2, 16, 16) for a 2-pod TPU
    production mesh (the pod axis becomes the top of the tree).

    Levels are numbered 1..L (paper convention). Bits are interleaved across
    axes from the innermost (last) axis outward, LSB first — the H-tree
    alternates pairing direction every level and the outermost axes (e.g.
    "pod") join last, i.e. nearest neighbors synchronize first.
    """

    shape: Tuple[int, ...]

    def __post_init__(self):
        if not self.shape or any(not _is_pow2(d) for d in self.shape):
            raise ValueError(f"mesh shape must be powers of two, got {self.shape}")
        if all(d == 1 for d in self.shape):
            raise ValueError("mesh must contain at least 2 tiles")

    # -- basic sizes ---------------------------------------------------------

    @property
    def num_tiles(self) -> int:
        return math.prod(self.shape)

    @property
    def num_levels(self) -> int:
        """L = log2(N): depth of the binary synchronization tree."""
        return int(math.log2(self.num_tiles))

    @property
    def num_fs_modules(self) -> int:
        """A binary tree over N leaves has N-1 internal FS modules (paper §4.2)."""
        return self.num_tiles - 1

    # -- level structure -----------------------------------------------------

    @cached_property
    def levels(self) -> Tuple[LevelSpec, ...]:
        """Interleave coordinate bits across axes, innermost axis first.

        For a square k×k mesh this yields the classic H-tree alternation
        x,y,x,y,...; for (2,16,16) the single pod bit is emitted last (root).
        """
        bits = [int(math.log2(d)) for d in self.shape]
        max_bits = max(bits)
        next_bit = [0] * len(self.shape)
        order: list[tuple[int, int]] = []
        # Round-robin innermost→outermost; axes with fewer bits join in the
        # LAST rounds so that short outer axes (e.g. a 2-pod axis) merge at
        # the top of the tree — physically-farther groups synchronize last.
        for r in range(max_bits):
            for axis in range(len(self.shape) - 1, -1, -1):
                if bits[axis] >= max_bits - r:
                    order.append((axis, next_bit[axis]))
                    next_bit[axis] += 1
        specs = []
        for lvl, (axis, bit) in enumerate(order, start=1):
            specs.append(
                LevelSpec(level=lvl, axis=axis, bit=bit, separation=1 << bit)
            )
        return tuple(specs)

    def level(self, level: int) -> LevelSpec:
        if not 1 <= level <= self.num_levels:
            raise ValueError(f"level {level} outside 1..{self.num_levels}")
        return self.levels[level - 1]

    # -- tile/partner/domain queries ------------------------------------------

    def _check_tile(self, tile: Coord) -> None:
        if len(tile) != len(self.shape) or any(
            not 0 <= c < d for c, d in zip(tile, self.shape)
        ):
            raise ValueError(f"tile {tile} outside mesh {self.shape}")

    def partner(self, tile: Coord, level: int) -> Coord:
        """Butterfly partner of ``tile`` at ``level``: toggle the level's bit.

        This is the software (all-ranks-active) equivalent of the H-tree: after
        levels 1..l every tile agrees with all tiles in its level-l domain.
        """
        self._check_tile(tile)
        spec = self.level(level)
        t = list(tile)
        t[spec.axis] ^= 1 << spec.bit
        return tuple(t)

    def domain_key(self, tile: Coord, level: int) -> Coord:
        """Canonical id of the sync domain containing ``tile`` after ``level``
        levels: coordinates with all merged bits cleared."""
        self._check_tile(tile)
        t = list(tile)
        for spec in self.levels[:level]:
            t[spec.axis] &= ~(1 << spec.bit)
        return tuple(t)

    def domain(self, tile: Coord, level: int) -> Tuple[Coord, ...]:
        """All tiles in ``tile``'s level-``level`` synchronization domain."""
        key = self.domain_key(tile, level)
        return tuple(
            t for t in self.tiles() if self.domain_key(t, level) == key
        )

    def domains(self, level: int) -> Tuple[Tuple[Coord, ...], ...]:
        """Partition of the mesh into level-``level`` synchronization domains
        (paper Fig. 2 purple dashed lines)."""
        groups: dict[Coord, list[Coord]] = {}
        for t in self.tiles():
            groups.setdefault(self.domain_key(t, level), []).append(t)
        return tuple(tuple(v) for _, v in sorted(groups.items()))

    def domain_size(self, level: int) -> int:
        return 1 << level

    def tiles(self) -> Iterator[Coord]:
        def rec(prefix: Tuple[int, ...], dims: Sequence[int]) -> Iterator[Coord]:
            if not dims:
                yield prefix
                return
            for c in range(dims[0]):
                yield from rec(prefix + (c,), dims[1:])

        yield from rec((), self.shape)

    # -- latency model (Table 1) ----------------------------------------------

    def fsync_latency(self, level: int | None = None, pipelined: bool = False) -> int:
        """Synchronization overhead Ŝ in cycles for aligned arrivals.

        Native FractalSync: 2 + 2·L (1 cycle per level up, 1 down, plus request
        sampling + wake).  FractalSync+Pipeline adds the per-level pipeline
        registers in both directions (paper Table 1).
        """
        level = self.num_levels if level is None else level
        specs = self.levels[:level]
        per_level = sum(1 + (s.pipeline_regs if pipelined else 0) for s in specs)
        return 2 + 2 * per_level

    def total_pipeline_regs(self, level: int | None = None) -> int:
        level = self.num_levels if level is None else level
        return sum(s.pipeline_regs for s in self.levels[:level])

    # -- H-tree wire accounting (for the area model) --------------------------

    def total_wire_pitches(self) -> float:
        """Total H-tree wiring in tile pitches: each level has N/2^l modules,
        each with two child wires of wire_pitches(l)."""
        total = 0.0
        for spec in self.levels:
            n_modules = self.num_tiles >> spec.level
            total += n_modules * 2 * spec.wire_pitches
        return total


def neighbor_tree() -> FractalTree:
    """The paper's 'Neighbor' configuration: two adjacent tiles, one FS module."""
    return FractalTree((1, 2))


def square_tree(k: int) -> FractalTree:
    """A k×k mesh (paper sweeps k ∈ {2,4,8,16})."""
    return FractalTree((k, k))
