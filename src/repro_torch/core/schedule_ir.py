"""Step-graph Schedule IR: every synchronization schedule as *data* (the
port's copy of ``repro/core/schedule_ir.py``; equal Programs, equal
``validate`` results).

The paper's contribution is a schedule — the H-tree recursion — evaluated
against Naïve and XY baselines.  Before this module the repo re-implemented
each schedule three times (point-to-point loops in ``collectives.py``,
hand-written event logic in ``simulator.py``, closed forms in
``cost_model.py``), and the three copies drifted.  Here a schedule is a
single declarative **step graph**, and the three layers become *consumers*:

  * ``collectives.ir_all_reduce``    lowers any all-reduce Program to row
    gathers and scatters on the rank-stacked ``[W, M]`` tensor (validated
    against the sum over the rank axis);
  * ``simulator.schedule_on_noc``    replays any Program on the contended
    XY-mesh NoC model (simulated latency for every software schedule);
  * ``cost_model.program_cost``      prices a Program from its step
    structure (α·steps + β·Σ payload, optional mesh congestion).

Representation (chunk DSL, in the spirit of MSCCLang): the payload V is cut
into ``n_chunks`` equal chunks; ranks are the row-major flattening of the
mesh ``shape`` (outermost axis first — bit 0 of the flat rank is the
innermost axis, exactly the H-tree order of ``core.tree.FractalTree``).  A
``Step`` is a set of ``Transfer``s executed concurrently; a ``Transfer``
moves a tuple of chunk ids from ``src`` to ``dst`` and either reduces into
the destination (``reduce=True``) or overwrites it.  Steps carry sync-tree
``level``, mesh ``axis`` and link ``tier`` metadata for the cost model and
the fsync-domain machinery.

Two program kinds:

  * ``all_reduce`` — lowerable: per step every rank sends at most one
    message and receives at most one (a partial permutation — exactly what
    one point-to-point exchange can express), and all transfers in a step carry
    the same number of chunks.
  * ``barrier``    — token programs (fan-in/fan-out allowed); consumed by
    the simulator's NoC/AMO executors, not lowered to tensors.

``validate`` abstract-interprets a program over *contribution sets* (which
source ranks have been summed into each chunk) and rejects double-counting
reduces and incomplete schedules — the IR analogue of the numerical
sum-over-ranks check.

Adding a schedule ≈ 20 lines: write a builder returning a ``Program`` (see
``tree_all_reduce`` below for the template), register it in ``BUILDERS``,
and all three backends plus the autotuner pick it up.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .tree import FractalTree

Shape = Tuple[int, ...]

ALL_REDUCE = "all_reduce"
BARRIER = "barrier"

TIER_INNER = "inner"   # priced on the fast (intra-pod / NoC) link
TIER_OUTER = "outer"   # priced on the slow (inter-pod) link


# ---------------------------------------------------------------------------
# IR node types
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Transfer:
    """One point-to-point message: ``chunks`` of the payload from src to dst.

    ``reduce=True``  → destination accumulates (+=) the incoming chunks;
    ``reduce=False`` → destination overwrites (gather/broadcast semantics).
    """

    src: int
    dst: int
    chunks: Tuple[int, ...]
    reduce: bool = True

    @property
    def n_chunks_moved(self) -> int:
        return len(self.chunks)


@dataclass(frozen=True)
class Step:
    """Transfers that may fly concurrently, plus scheduling metadata.

    level : synchronization-tree level this step realizes (1-based, None if
            the schedule is not tree-structured)
    axis  : mesh axis index the communication travels along (None if mixed)
    tier  : which link class prices this step ("inner" | "outer")
    """

    transfers: Tuple[Transfer, ...]
    level: Optional[int] = None
    axis: Optional[int] = None
    tier: str = TIER_INNER

    def senders(self) -> List[int]:
        return [t.src for t in self.transfers]

    def receivers(self) -> List[int]:
        return [t.dst for t in self.transfers]

    @property
    def max_chunks_moved(self) -> int:
        return max((t.n_chunks_moved for t in self.transfers), default=0)


@dataclass(frozen=True)
class BucketMeta:
    """Which slice of a bucketed superstep payload a Program moves.

    The SuperstepEngine (``core.superstep``) cuts the flat gradient vector
    into size-bounded buckets and compiles one Program per bucket; this
    metadata makes bucket identity part of the IR so every consumer — the
    JAX lowering, the NoC replay, the cost model, the autotuner — agrees on
    *which* bytes a program is responsible for and where they live in the
    step's flat payload.

    index        : bucket position in ready order (0 = first grads ready,
                   i.e. the LAST layers of the model — reverse-layer order)
    n_buckets    : total buckets in the superstep
    offset_elems : start of this bucket in the bucket-ordered flat vector
    length_elems : padded element count of this bucket
    codec        : wire codec this bucket's payload rides ("bf16" | "int8";
                   None = uncompressed) — the per-bucket compression policy
                   the autotuner picks is part of bucket identity too
    """

    index: int
    n_buckets: int
    offset_elems: int
    length_elems: int
    codec: Optional[str] = None


@dataclass(frozen=True)
class Program:
    """A complete schedule: ordered steps over a flat rank space."""

    name: str
    shape: Shape                 # mesh shape; ranks are row-major flattened
    n_chunks: int                # payload granularity (V / n_chunks per chunk)
    steps: Tuple[Step, ...]
    kind: str = ALL_REDUCE
    bucket: Optional[BucketMeta] = None   # set when part of a bucketed step

    def with_bucket(self, meta: BucketMeta) -> "Program":
        return Program(self.name, self.shape, self.n_chunks, self.steps,
                       self.kind, meta)

    @property
    def world(self) -> int:
        return math.prod(self.shape)

    @property
    def num_steps(self) -> int:
        return len(self.steps)

    def frac(self, transfer: Transfer) -> float:
        """Fraction of the full payload V a transfer moves."""
        return transfer.n_chunks_moved / self.n_chunks

    def per_rank_frac_sent(self) -> Dict[int, float]:
        """Σ payload fraction each rank puts on the wire across all steps."""
        out: Dict[int, float] = {r: 0.0 for r in range(self.world)}
        for step in self.steps:
            for t in step.transfers:
                out[t.src] += self.frac(t)
        return out

    def describe(self) -> str:
        msgs = sum(len(s.transfers) for s in self.steps)
        vol = max(self.per_rank_frac_sent().values(), default=0.0)
        tag = ""
        if self.bucket is not None:
            tag = (f" bucket {self.bucket.index}/{self.bucket.n_buckets}"
                   f" @{self.bucket.offset_elems}"
                   f"+{self.bucket.length_elems}")
        return (f"{self.name}[{'x'.join(map(str, self.shape))}]: "
                f"{self.num_steps} steps, {msgs} msgs, "
                f"{vol:.3g}·V max per-rank send volume{tag}")


class ScheduleError(ValueError):
    """An IR program violates its kind's structural or semantic invariants."""


# ---------------------------------------------------------------------------
# flat-rank geometry helpers
# ---------------------------------------------------------------------------


def rank_coords(shape: Shape, rank: int) -> Tuple[int, ...]:
    """Row-major (outermost-first) coordinates of a flat rank."""
    coords = []
    for d in reversed(shape):
        coords.append(rank % d)
        rank //= d
    return tuple(reversed(coords))


def coords_rank(shape: Shape, coords: Sequence[int]) -> int:
    rank = 0
    for c, d in zip(coords, shape):
        rank = rank * d + c
    return rank


def as_2d(shape: Shape) -> Tuple[int, int]:
    """Collapse a mesh shape to (rows, cols) for NoC placement/routing:
    the innermost axis becomes columns, everything else stacks into rows."""
    if len(shape) == 1:
        return (1, shape[0])
    return (math.prod(shape[:-1]), shape[-1])


def tree_bit_positions(shape: Shape) -> Tuple[int, ...]:
    """Flat-rank bit position merged at each FractalTree level (1-based
    levels → index 0 is level 1).  Bit 0 of the flat rank is the LSB of the
    innermost axis, so position(axis, bit) = Σ_{inner axes} log2(size) + bit.
    """
    tree = FractalTree(shape)
    width = [int(math.log2(d)) for d in shape]
    offset = []
    for a in range(len(shape)):
        offset.append(sum(width[a + 1:]))
    return tuple(offset[s.axis] + s.bit for s in tree.levels)


def _check_pow2(shape: Shape) -> int:
    n = math.prod(shape)
    L = int(math.log2(n)) if n > 0 else 0
    if n < 1 or (1 << L) != n:
        raise ScheduleError(f"IR schedules need a power-of-two world, "
                            f"got shape {shape} (world {n})")
    return L


def _bit(v: int, pos: int) -> int:
    return (v >> pos) & 1


def _agrees(c: int, r: int, positions: Iterable[int]) -> bool:
    return all(_bit(c, p) == _bit(r, p) for p in positions)


# ---------------------------------------------------------------------------
# builders: the six all-reduce schedules
# ---------------------------------------------------------------------------


def _butterfly_steps(world: int, n_chunks: int, bits: Sequence[int],
                     tiers: Sequence[str], axes: Sequence[Optional[int]],
                     base_level: int = 0) -> List[Step]:
    """Recursive halving-doubling over an explicit bit sequence.

    Phase 1 (reduce-scatter): at sub-step i every rank keeps the half of its
    working chunk set agreeing with its own bit ``bits[i]`` and sends the
    other half to the partner across that bit.  Phase 2 mirrors it with
    gathers.  The classic butterfly is ``bits = tree_bit_positions(shape)``;
    the hierarchical schedule is the same recursion with inner bits first.
    """
    steps: List[Step] = []
    # reduce-scatter by halves
    for i, p in enumerate(bits):
        transfers = []
        for r in range(world):
            send = tuple(c for c in range(n_chunks)
                         if _agrees(c, r, bits[:i]) and _bit(c, p) != _bit(r, p))
            transfers.append(Transfer(r, r ^ (1 << p), send, reduce=True))
        steps.append(Step(tuple(transfers), level=base_level + i + 1,
                          axis=axes[i], tier=tiers[i]))
    # all-gather by doubles
    for i in reversed(range(len(bits))):
        p = bits[i]
        transfers = []
        for r in range(world):
            own = tuple(c for c in range(n_chunks)
                        if _agrees(c, r, bits[:i + 1]))
            transfers.append(Transfer(r, r ^ (1 << p), own, reduce=False))
        steps.append(Step(tuple(transfers), level=base_level + i + 1,
                          axis=axes[i], tier=tiers[i]))
    return steps


def butterfly_all_reduce(shape: Shape) -> Program:
    """The FractalSync schedule: recursive halving-doubling whose partner
    sequence follows the H-tree level order (``FractalTree.partner``) —
    innermost axis first, axes alternating, pods last."""
    L = _check_pow2(shape)
    world = 1 << L
    bits = tree_bit_positions(shape)
    tree = FractalTree(shape)
    axes = [s.axis for s in tree.levels]
    steps = _butterfly_steps(world, world, bits, [TIER_INNER] * L, axes)
    return Program("fractal", shape, world, tuple(steps))


def hierarchical_all_reduce(shape: Shape, n_outer_axes: int = 1) -> Program:
    """The butterfly recursion at pod granularity: all inner-axis bits
    reduce-scatter first (fast links), the outer/pod bits all-reduce in the
    middle on 1/inner_world of the bytes (slow links), inner bits gather
    last.  Same algebra as the butterfly — only the bit order and the link
    tier of the middle steps change."""
    L = _check_pow2(shape)
    world = 1 << L
    if len(shape) <= n_outer_axes:
        return butterfly_all_reduce(shape)._replace_name("hierarchical")
    width = [int(math.log2(d)) for d in shape]
    offset = [sum(width[a + 1:]) for a in range(len(shape))]
    inner_axes = list(range(n_outer_axes, len(shape)))
    outer_axes = list(range(n_outer_axes))
    bits, axes, tiers = [], [], []
    for a in reversed(inner_axes):       # innermost first
        for b in range(width[a]):
            bits.append(offset[a] + b)
            axes.append(a)
            tiers.append(TIER_INNER)
    for a in reversed(outer_axes):
        for b in range(width[a]):
            bits.append(offset[a] + b)
            axes.append(a)
            tiers.append(TIER_OUTER)
    steps = _butterfly_steps(world, world, bits, tiers, axes)
    return Program("hierarchical", shape, world, tuple(steps))


def _ring_steps(ranks: Sequence[int], blocks: Sequence[Tuple[int, ...]],
                axis: Optional[int], tier: str) -> List[Step]:
    """Ring reduce-scatter + all-gather among ``ranks`` (in ring order),
    with ``blocks[j]`` the chunk block member j eventually owns+1."""
    k = len(ranks)
    rs: List[List[Transfer]] = [[] for _ in range(k - 1)]
    ag: List[List[Transfer]] = [[] for _ in range(k - 1)]
    for s in range(k - 1):
        for j in range(k):
            nxt = (j + 1) % k
            rs[s].append(Transfer(ranks[j], ranks[nxt],
                                  blocks[(j - s) % k], reduce=True))
            ag[s].append(Transfer(ranks[j], ranks[nxt],
                                  blocks[(j + 1 - s) % k], reduce=False))
    return [Step(tuple(ts), axis=axis, tier=tier) for ts in rs + ag]


def _contiguous_blocks(n_chunks: int, k: int) -> List[Tuple[int, ...]]:
    size = n_chunks // k
    return [tuple(range(j * size, (j + 1) * size)) for j in range(k)]


def ring_all_reduce(shape: Shape) -> Program:
    """Flat bandwidth-optimal ring over the whole world: 2(N−1) steps of
    V/N-sized chunks between flat-rank neighbors.  (Any world size — the
    ring does not need the power-of-two structure the tree schedules do.)"""
    world = math.prod(shape)
    if world == 1:
        return Program("ring", shape, 1, ())
    blocks = _contiguous_blocks(world, world)
    steps = _ring_steps(list(range(world)), blocks, axis=None,
                        tier=TIER_INNER)
    # interleave RS and AG metadata is already positional; merge into steps
    return Program("ring", shape, world, tuple(steps))


def xy_all_reduce(shape: Shape) -> Program:
    """The paper's XY baseline: dimension-ordered ring all-reduce — a full
    ring along the innermost axis within each line, then along each outer
    axis in turn.  Latency O(Σ axis sizes), bandwidth 2V·Σ (k−1)/k."""
    world = math.prod(shape)
    if world == 1:
        return Program("xy", shape, 1, ())
    n_chunks = world
    steps: List[Step] = []
    # innermost axis first, then outward — matches collectives.all_reduce
    for a in range(len(shape) - 1, -1, -1):
        k = shape[a]
        if k == 1:
            continue
        blocks = _contiguous_blocks(n_chunks, k)
        # one ring per line of constant other-coordinates
        lines: List[List[int]] = []
        for r in range(world):
            coords = rank_coords(shape, r)
            if coords[a] == 0:
                line = [coords_rank(shape, coords[:a] + (c,) + coords[a + 1:])
                        for c in range(k)]
                lines.append(line)
        # merge the per-line ring steps positionally (lines are disjoint)
        merged: List[List[Transfer]] = [[] for _ in range(2 * (k - 1))]
        for line in lines:
            for i, st in enumerate(_ring_steps(line, blocks, a, TIER_INNER)):
                merged[i].extend(st.transfers)
        steps.extend(Step(tuple(ts), axis=a, tier=TIER_INNER)
                     for ts in merged)
    return Program("xy", shape, n_chunks, tuple(steps))


def naive_all_reduce(shape: Shape) -> Program:
    """The paper's Naïve baseline: every contribution serially funneled into
    rank 0's port (N−1 full-payload steps), then serially broadcast back.
    O(N) steps each moving the whole V — the quadratic-cost scheme."""
    world = math.prod(shape)
    if world == 1:
        return Program("naive", shape, 1, ())
    all_chunks = tuple(range(world))
    steps = [Step((Transfer(s, 0, all_chunks, reduce=True),))
             for s in range(1, world)]
    steps += [Step((Transfer(0, s, all_chunks, reduce=False),))
              for s in range(1, world)]
    return Program("naive", shape, world, tuple(steps))


def tree_all_reduce(shape: Shape) -> Program:
    """Two-phase tree reduce-broadcast (beyond-paper; SynCron-style): phase 1
    reduces the full payload up the H-tree (only subtree masters active),
    phase 2 broadcasts the result back down.  2·log2(N) steps like the
    butterfly but O(V·log N) bytes — latency-optimal, bandwidth-greedy."""
    L = _check_pow2(shape)
    world = 1 << L
    bits = tree_bit_positions(shape)
    tree = FractalTree(shape)
    all_chunks = tuple(range(world))
    steps: List[Step] = []
    for i, p in enumerate(bits):    # reduce up: child with bit set → master
        transfers = tuple(
            Transfer(r | (1 << p), r, all_chunks, reduce=True)
            for r in range(world)
            if _bit(r, p) == 0 and all(_bit(r, q) == 0 for q in bits[:i]))
        steps.append(Step(transfers, level=i + 1,
                          axis=tree.levels[i].axis))
    for i in reversed(range(L)):    # broadcast down: master → child
        p = bits[i]
        transfers = tuple(
            Transfer(r, r | (1 << p), all_chunks, reduce=False)
            for r in range(world)
            if _bit(r, p) == 0 and all(_bit(r, q) == 0 for q in bits[:i]))
        steps.append(Step(transfers, level=i + 1,
                          axis=tree.levels[i].axis))
    return Program("tree", shape, world, tuple(steps))


def _replace_name(self: Program, name: str) -> Program:
    return Program(name, self.shape, self.n_chunks, self.steps, self.kind,
                   self.bucket)


Program._replace_name = _replace_name  # small private helper


# ---------------------------------------------------------------------------
# builders: barrier (token) programs
# ---------------------------------------------------------------------------


def butterfly_barrier(shape: Shape, level: Optional[int] = None) -> Program:
    """fsync(level) as IR: recursive doubling of a unit token over the first
    ``level`` tree levels (None → root = whole world)."""
    L = _check_pow2(shape)
    level = L if level is None else level
    if not 0 <= level <= L:
        raise ScheduleError(f"fsync level {level} outside 0..{L}")
    world = 1 << L
    bits = tree_bit_positions(shape)[:level]
    tree = FractalTree(shape)
    steps = [
        Step(tuple(Transfer(r, r ^ (1 << p), (0,), reduce=True)
                   for r in range(world)),
             level=i + 1, axis=tree.levels[i].axis)
        for i, p in enumerate(bits)
    ]
    return Program("fractal_barrier", shape, 1, tuple(steps), kind=BARRIER)


def naive_barrier(shape: Shape) -> Program:
    """Centralized AMO barrier topology: all tiles gather at the master,
    release fans back out (the simulator adds the counter/poll protocol)."""
    world = math.prod(shape)
    gather = Step(tuple(Transfer(r, 0, (0,), reduce=True)
                        for r in range(1, world)), level=1)
    release = Step(tuple(Transfer(0, r, (0,), reduce=False)
                         for r in range(1, world)), level=1)
    return Program("naive_barrier", shape, 1, (gather, release), kind=BARRIER)


def xy_barrier(shape: Shape) -> Program:
    """Dimension-ordered barrier topology: lines gather on line-masters
    (innermost axis), line-masters gather on the global master, release
    cascades back — the paper's XY scheme as a 2-level gather tree."""
    if len(shape) < 2:
        return naive_barrier(shape)._replace_name("xy_barrier")
    rows, cols = as_2d(shape)
    world = rows * cols

    def flat(r, c):
        return r * cols + c

    up1 = Step(tuple(Transfer(flat(r, c), flat(r, 0), (0,), reduce=True)
                     for r in range(rows) for c in range(1, cols)), level=1,
               axis=len(shape) - 1)
    up2 = Step(tuple(Transfer(flat(r, 0), 0, (0,), reduce=True)
                     for r in range(1, rows)), level=2, axis=0)
    down2 = Step(tuple(Transfer(0, flat(r, 0), (0,), reduce=False)
                       for r in range(1, rows)), level=2, axis=0)
    down1 = Step(tuple(Transfer(flat(r, 0), flat(r, c), (0,), reduce=False)
                       for r in range(rows) for c in range(1, cols)), level=1,
                 axis=len(shape) - 1)
    return Program("xy_barrier", shape, 1, (up1, up2, down2, down1),
                   kind=BARRIER)


def tree_barrier(shape: Shape, level: Optional[int] = None) -> Program:
    """H-tree barrier as a gather tree (masters only) — the software shape
    of the paper's dedicated FS-module tree, and the topology SynCron-style
    hierarchical AMO synchronization uses."""
    L = _check_pow2(shape)
    level = L if level is None else level
    world = math.prod(shape)
    bits = tree_bit_positions(shape)[:level]
    tree = FractalTree(shape)
    steps: List[Step] = []
    for i, p in enumerate(bits):
        steps.append(Step(tuple(
            Transfer(r | (1 << p), r, (0,), reduce=True)
            for r in range(world)
            if _bit(r, p) == 0 and all(_bit(r, q) == 0 for q in bits[:i])),
            level=i + 1, axis=tree.levels[i].axis))
    for i in reversed(range(len(bits))):
        p = bits[i]
        steps.append(Step(tuple(
            Transfer(r, r | (1 << p), (0,), reduce=False)
            for r in range(world)
            if _bit(r, p) == 0 and all(_bit(r, q) == 0 for q in bits[:i])),
            level=i + 1, axis=tree.levels[i].axis))
    return Program("tree_barrier", shape, 1, tuple(steps), kind=BARRIER)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

BUILDERS = {
    "fractal": butterfly_all_reduce,
    "ring": ring_all_reduce,
    "xy": xy_all_reduce,
    "naive": naive_all_reduce,
    "hierarchical": hierarchical_all_reduce,
    "tree": tree_all_reduce,
}

BARRIER_BUILDERS = {
    "fractal": butterfly_barrier,
    "naive": naive_barrier,
    "xy": xy_barrier,
    "tree": tree_barrier,
}

SCHEDULES = tuple(BUILDERS)


@lru_cache(maxsize=256)
def build_program(schedule: str, shape: Shape) -> Program:
    """Build + validate the named all-reduce schedule for a mesh shape."""
    if schedule not in BUILDERS:
        raise ScheduleError(
            f"unknown schedule {schedule!r}; one of {SCHEDULES}")
    prog = BUILDERS[schedule](tuple(shape))
    validate(prog)
    return prog


# ---------------------------------------------------------------------------
# validation: structural invariants + contribution-set abstract interpretation
# ---------------------------------------------------------------------------


def validate(prog: Program) -> Dict[str, float]:
    """Check the program is executable and *means* an all-reduce/barrier.

    Structural (all_reduce kind — what one exchange per step can express):
      * per step, every rank sends at most one message and receives at most
        one;
      * all transfers within a step move the same number of chunks;
      * chunk ids are within range and distinct per transfer.

    Semantic (contribution sets): start rank r with {r} on every chunk;
    reduces must merge *disjoint* sets (double-count = wrong sum), copies
    overwrite; at the end every rank's every chunk must hold the full set
    (for barrier kind: token knowledge must reach everyone — disjointness
    is waived because token counting is idempotent for the barrier's
    purpose).

    Returns summary stats used by tests and the autotuner.
    """
    world = prog.world
    n = prog.n_chunks
    full = frozenset(range(world))
    # state[r][c] = set of source ranks whose contribution is in chunk c at r
    state = [[frozenset([r]) for _ in range(n)] for r in range(world)]
    for si, step in enumerate(prog.steps):
        seen_src: Dict[int, int] = {}
        seen_dst: Dict[int, int] = {}
        sizes = set()
        staged: List[Tuple[Transfer, List[frozenset]]] = []
        for t in step.transfers:
            if not (0 <= t.src < world and 0 <= t.dst < world):
                raise ScheduleError(f"step {si}: rank out of range in {t}")
            if t.src == t.dst:
                raise ScheduleError(f"step {si}: self-send in {t}")
            if len(set(t.chunks)) != len(t.chunks):
                raise ScheduleError(f"step {si}: duplicate chunk ids in {t}")
            if any(not 0 <= c < n for c in t.chunks):
                raise ScheduleError(f"step {si}: chunk id out of range in {t}")
            if prog.kind == ALL_REDUCE:
                if t.src in seen_src:
                    raise ScheduleError(
                        f"step {si}: rank {t.src} sends twice")
                if t.dst in seen_dst:
                    raise ScheduleError(
                        f"step {si}: rank {t.dst} receives twice")
            seen_src[t.src] = seen_src.get(t.src, 0) + 1
            seen_dst[t.dst] = seen_dst.get(t.dst, 0) + 1
            sizes.add(t.n_chunks_moved)
            # snapshot sender state: all sends in a step happen before any
            # receive lands (BSP semantics within the step)
            staged.append((t, [state[t.src][c] for c in t.chunks]))
        if prog.kind == ALL_REDUCE and len(sizes) > 1:
            raise ScheduleError(
                f"step {si}: nonuniform transfer sizes {sorted(sizes)} "
                "(one exchange per step needs same-shaped messages)")
        for t, payload in staged:
            for c, contrib in zip(t.chunks, payload):
                if t.reduce:
                    if prog.kind == ALL_REDUCE and state[t.dst][c] & contrib:
                        raise ScheduleError(
                            f"step {si}: double-counted contribution "
                            f"{sorted(state[t.dst][c] & contrib)} into "
                            f"chunk {c} at rank {t.dst}")
                    state[t.dst][c] = state[t.dst][c] | contrib
                else:
                    state[t.dst][c] = contrib
    if prog.kind == ALL_REDUCE:
        for r in range(world):
            for c in range(n):
                if state[r][c] != full:
                    raise ScheduleError(
                        f"incomplete all-reduce: rank {r} chunk {c} has "
                        f"{len(state[r][c])}/{world} contributions")
    else:
        for r in range(world):
            if state[r][0] != full:
                raise ScheduleError(
                    f"incomplete barrier: rank {r} knows only "
                    f"{len(state[r][0])}/{world} ranks")
    fracs = prog.per_rank_frac_sent()
    return {
        "steps": prog.num_steps,
        "messages": sum(len(s.transfers) for s in prog.steps),
        "max_frac_sent": max(fracs.values(), default=0.0),
        "sum_step_frac": sum(
            s.max_chunks_moved / prog.n_chunks for s in prog.steps),
    }
