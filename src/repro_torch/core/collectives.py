"""FractalSync collectives on a rank-stacked tensor (port of
``repro/core/collectives.py``).

One device holds a whole BSP world: rank ``r``'s payload is row ``r`` of a
``[W, M]`` tensor (the layout ``jax.vmap(fn, axis_name="data")`` gives the
reference).  A point-to-point exchange at butterfly level ``b`` is the row
permutation ``r -> r ^ (1 << b)``; ``rank_index(W)`` takes the place of the
reference's ``flat_index``.  Row r is the reference's row-major flat rank
over the mesh ``shape`` (outermost axis first, so bit 0 is the innermost
axis).  Every schedule applies its steps in order, staging all sends
before the receives, so the results are the reference's bit for bit:

  * ``fractal_barrier``        — recursive-doubling fsync token;
  * ``fractal_reduce_scatter`` — recursive halving, log2(W) hops, each hop
                                 ONE ``decode_add`` launch over all ranks'
                                 kept halves when a codec rides the wire;
  * ``fractal_all_gather``     — its inverse (recursive doubling);
  * ``fractal_all_reduce``     — the two halves back to back;
  * ``ir_all_reduce``          — any all-reduce Schedule-IR ``Program``
                                 lowered to row gathers and scatters, one
                                 per IR step; ``all_reduce`` routes every
                                 software schedule through it;
  * ``ring_all_reduce``, ``xy_all_reduce``, ``naive_all_reduce``,
    ``hierarchical_all_reduce`` — the reference's hand-rolled lowerings,
    kept as cross-checks of the IR, as the reference keeps them;
  * ``bit_reversed_index``, ``reduce_scatter``, ``all_gather_flat`` — the
    ZeRO-1 shard layout (rank r holds chunk rev(r) after the scatter).

Collectives take the IR ``shape`` tuple where the reference takes mesh
``sizes`` (default ``(W,)``); the fractal schedules need a power-of-two
world, ``ring``/``xy``/``naive`` run on any.  ``"xla"`` (``lax.psum`` in
the reference) is a plain sum over the rank axis.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels.tree_reduce.ops import decode_add

from . import schedule_ir

SCHEDULES = schedule_ir.SCHEDULES + ("xla",)


def rank_index(world: int, device=None) -> torch.Tensor:
    """Every rank's flat index, ``[W]`` int64 (the rank axis of the
    stacked tensor is the reference's row-major flat index)."""
    return torch.arange(world, device=device)


def _n_levels(world: int) -> int:
    L = int(math.log2(world)) if world > 0 else -1
    if L < 0 or 1 << L != world:
        raise ValueError(f"fractal schedules need power-of-two world, got "
                         f"{world}")
    return L


def _partners(world: int, b: int, device) -> torch.Tensor:
    return rank_index(world, device) ^ (1 << b)


def _exchange(send: torch.Tensor, b: int) -> torch.Tensor:
    """Row r receives row ``r ^ (1 << b)`` (one butterfly ppermute)."""
    return send[_partners(send.shape[0], b, send.device)]


def _codec_exchange(send, b: int, codec):
    """One point-to-point exchange, optionally codec-compressed on the
    wire: encode every rank's row → permute every wire leaf → decode."""
    if codec is None:
        return _exchange(send, b)
    wire = {k: _exchange(v, b) for k, v in codec.encode(send).items()}
    return codec.decode(wire, send.shape, send.dtype)


def _codec_exchange_add(keep, send, b: int, codec):
    """``keep + exchange(send)`` — the receive side of every reduce hop.
    With a codec, the wire-decode is fused into the accumulate by
    ``kernels.tree_reduce.ops.decode_add``: one launch over all ranks."""
    if codec is None:
        return keep + _exchange(send, b)
    wire = {k: _exchange(v, b) for k, v in codec.encode(send).items()}
    return decode_add(keep, wire, codec)


def _halves(x: torch.Tensor, b: int):
    """(keep, send) of every rank at level b: bit b of rank r picks the
    kept half (0 → low, 1 → high), the other half is sent."""
    W, M = x.shape
    xv = x.reshape(W, 2, M // 2)
    r = rank_index(W, x.device)
    bit = (r >> b) & 1
    return xv[r, bit], xv[r, 1 - bit]


def _join(mine: torch.Tensor, recv: torch.Tensor, b: int) -> torch.Tensor:
    """One doubling step: rank r's piece goes low if bit b of r is 0,
    the received piece fills the other half."""
    W, m = mine.shape
    out = mine.new_empty(W, 2, m)
    r = rank_index(W, mine.device)
    bit = (r >> b) & 1
    out[r, bit] = mine
    out[r, 1 - bit] = recv
    return out.view(W, 2 * m)


def _check_payload(x: torch.Tensor, world: int):
    if x.ndim != 2:
        raise ValueError(f"rank-stacked payloads are [W, M], got "
                         f"{tuple(x.shape)}")
    if x.shape[1] % world:
        raise ValueError(f"payload length {x.shape[1]} not divisible by "
                         f"world {world}")


def fractal_barrier(world: int, level: Optional[int] = None, token=None,
                    device=None) -> torch.Tensor:
    """fsync(level): recursive-doubling barrier over the lowest ``level``
    levels of the synchronization tree (None → the whole world).  Returns
    every rank's token, ``[W]`` int32, equal to the size of its sync
    domain."""
    L = _n_levels(world)
    level = L if level is None else level
    if not 0 <= level <= L:
        raise ValueError(f"fsync level {level} outside 0..{L}")
    tok = torch.ones(world, dtype=torch.int32, device=device) \
        if token is None else token
    for b in range(level):
        tok = tok + _exchange(tok, b)
    return tok


def _reduce_scatter_bits(x: torch.Tensor, bits: Sequence[int], codec=None
                         ) -> torch.Tensor:
    """Recursive halving over the butterfly levels ``bits`` (the rank bits
    whose partners exchange), each hop ``keep + exchange(send)``."""
    for b in bits:
        keep, send = _halves(x, b)
        x = _codec_exchange_add(keep, send, b, codec)
    return x


def _all_gather_bits(x: torch.Tensor, bits: Sequence[int], codec=None
                     ) -> torch.Tensor:
    """Recursive doubling over ``bits`` in reverse: the inverse of
    ``_reduce_scatter_bits``, ``codec`` on every exchanged payload."""
    for b in reversed(bits):
        x = _join(x, _codec_exchange(x, b, codec), b)
    return x


def fractal_reduce_scatter(x: torch.Tensor, codec=None) -> torch.Tensor:
    """Reduce-scatter by recursive halving: ``[W, M]`` → ``[W, M/W]``, rank
    r ending with the sum of chunk rev(r) (LSB-first shard order;
    ``fractal_all_gather`` inverts it).  ``codec`` compresses each
    exchanged half on the wire; partial sums are re-quantized per hop."""
    W = x.shape[0]
    L = _n_levels(W)
    _check_payload(x, W)
    return _reduce_scatter_bits(x, range(L), codec)


def fractal_all_gather(x: torch.Tensor) -> torch.Tensor:
    """Inverse of ``fractal_reduce_scatter`` (all-gather by doubling):
    ``[W, m]`` → ``[W, m*W]``, every row the gathered payload."""
    return _all_gather_bits(x, range(_n_levels(x.shape[0])))


def fractal_all_reduce(x: torch.Tensor, codec=None) -> torch.Tensor:
    """Recursive halving-doubling all-reduce: the reduce-scatter, then the
    all-gather by doubles with ``codec`` on every exchanged payload."""
    W = x.shape[0]
    L = _n_levels(W)
    _check_payload(x, W)
    x = _reduce_scatter_bits(x, range(L), codec)
    return _all_gather_bits(x, range(L), codec)


# ---------------------------------------------------------------------------
# the paper's baselines, hand-rolled (cross-checks of the IR lowering)
# ---------------------------------------------------------------------------


def _shape_of(x: torch.Tensor, shape: Optional[Sequence[int]]
              ) -> Tuple[int, ...]:
    shape = (x.shape[0],) if shape is None else tuple(shape)
    if math.prod(shape) != x.shape[0]:
        raise ValueError(f"mesh shape {shape} does not hold the {x.shape[0]} "
                         "ranks of the payload")
    return shape


def ring_all_reduce(x: torch.Tensor, shape: Optional[Sequence[int]] = None,
                    axis: int = 0) -> torch.Tensor:
    """Ring all-reduce along mesh axis ``axis`` of ``shape`` (default the
    whole rank axis): reduce-scatter ring + all-gather ring, 2(k−1) steps,
    each rank sending to its predecessor on the ring, as the reference's
    ``ring_all_reduce(x, axis_name, size)``."""
    shape = _shape_of(x, shape)
    k = shape[axis]
    if k == 1:
        return x
    W, M = x.shape
    if M % k:
        raise ValueError(f"leading dim {M} not divisible by ring {k}")
    # [k (the ring axis), R (every other mesh axis), k chunks, chunk]
    xv = x.reshape(*shape, k, M // k).movedim(axis, 0).reshape(
        k, W // k, k, M // k)
    idx = torch.arange(k, device=x.device)

    def chunk_at(c):
        return xv[idx, :, c]                       # [k, R, chunk]

    acc = chunk_at((idx + 1) % k)
    for s in range(k - 1):
        acc = torch.roll(acc, -1, 0)               # rank i receives i + 1
        acc = acc + chunk_at((idx + 1 + s + 1) % k)
    out = torch.empty_like(xv)
    cur = acc
    for j in range(k):
        if j:
            cur = torch.roll(cur, -1, 0)
        out[idx, :, (idx + j) % k] = cur
    rest = [n for i, n in enumerate(shape) if i != axis]
    return out.reshape(k, *rest, k, M // k).movedim(0, axis).reshape(W, M)


def xy_all_reduce(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """The paper's XY scheme on a 2-D ``shape`` ``(size_x, size_y)``: ring
    all-reduce along x, then along y."""
    shape = _shape_of(x, shape)
    if len(shape) != 2:
        raise ValueError(f"xy_all_reduce needs a 2-D mesh, got {shape}")
    return ring_all_reduce(ring_all_reduce(x, shape, 0), shape, 1)


def naive_all_reduce(x: torch.Tensor) -> torch.Tensor:
    """The paper's Naïve scheme: every rank's payload is funnelled, one per
    step, to rank 0, which adds them in rank order; the total is then
    broadcast back out.  O(W) serial steps."""
    acc = x[0]
    for r in range(1, x.shape[0]):
        acc = acc + x[r]
    return acc.unsqueeze(0).expand_as(x).clone()


def hierarchical_all_reduce(x: torch.Tensor, inner_world: int
                            ) -> torch.Tensor:
    """Fractal recursion at pod granularity: reduce-scatter by halving
    inside each pod of ``inner_world`` neighbouring ranks, butterfly
    all-reduce of the 1/inner shard across pods, all-gather inside the pod.
    Inter-pod traffic shrinks by the intra-pod world size."""
    W = x.shape[0]
    L, Li = _n_levels(W), _n_levels(inner_world)
    _check_payload(x, W)
    x = _reduce_scatter_bits(x, range(Li))
    x = _all_gather_bits(_reduce_scatter_bits(x, range(Li, L)), range(Li, L))
    return _all_gather_bits(x, range(Li))


# ---------------------------------------------------------------------------
# Schedule IR lowering: any all-reduce Program → row gathers and scatters
# ---------------------------------------------------------------------------

def _step_tables(step: schedule_ir.Step):
    """Host tables for one IR step: the transfers' source and destination
    ranks ``[n]`` and their chunk ids ``[n, k]`` (sent from and received
    into the same ids), plus whether the step reduces or copies.  The
    validator guarantees each rank sends and receives at most once per
    step and every transfer moves ``k`` chunks; every builder's steps are
    all-reduce or all-copy, and a step that mixes the two is refused."""
    ts = step.transfers
    reduce = ts[0].reduce
    if any(t.reduce != reduce for t in ts):
        raise ValueError("an IR step mixes reduce and copy transfers")
    src = torch.tensor([t.src for t in ts], dtype=torch.int64)
    dst = torch.tensor([t.dst for t in ts], dtype=torch.int64)
    chunks = torch.tensor([t.chunks for t in ts], dtype=torch.int64)
    return src, dst, chunks, reduce


@lru_cache(maxsize=256)
def _host_tables(prog: schedule_ir.Program) -> tuple:
    """Every non-empty step's tables, built once per Program."""
    return tuple(_step_tables(s) for s in prog.steps if s.transfers)


@lru_cache(maxsize=256)
def _program_tables(prog: schedule_ir.Program, device: str) -> tuple:
    """``_host_tables`` on ``device``, copied once per (Program, device):
    no host copy per call, and a CPU run never hands its tables to the
    card."""
    return tuple(tuple(v.to(device) if isinstance(v, torch.Tensor) else v
                       for v in tables) for tables in _host_tables(prog))


def ir_all_reduce(x: torch.Tensor, prog: schedule_ir.Program
                  ) -> torch.Tensor:
    """Execute an all-reduce IR Program on a rank-stacked ``[W, M]`` payload.

    Each row is viewed as ``[n_chunks, chunk]``.  Per IR step every
    transfer's send chunks are gathered (all sends stage before any receive
    lands), then each destination's receive chunks are added to (``reduce``)
    or overwritten.  Each received element gets exactly one f32 add, as the
    reference's ``buf.at[rids].add(recv)``, so the result is the
    reference's bit for bit.  The step tables live on the device; the
    lowering makes no synchronising call."""
    if prog.kind != schedule_ir.ALL_REDUCE:
        raise ValueError(f"cannot lower {prog.kind!r} program {prog.name!r}")
    W, M = x.shape[0], x.shape[1]
    if W != prog.world:
        raise ValueError(f"payload of {W} ranks, program {prog.name!r} of "
                         f"{prog.world}")
    if prog.world == 1:
        return x
    n_chunks = prog.n_chunks
    if M % n_chunks:
        raise ValueError(f"leading dim {M} not divisible by {n_chunks} "
                         f"chunks of {prog.name!r}")
    buf = x.reshape(W, n_chunks, -1).clone()
    for src, dst, chunks, reduce in _program_tables(prog, str(x.device)):
        data = buf[src[:, None], chunks]                 # [n, k, chunk]
        dst = dst[:, None]
        if reduce:
            data = buf[dst, chunks] + data
        buf[dst, chunks] = data
    return buf.reshape(x.shape)


def all_reduce(x: torch.Tensor, schedule: str,
               shape: Optional[Sequence[int]] = None) -> torch.Tensor:
    """All-reduce (sum) of a rank-stacked payload over the mesh ``shape``.

    Every software schedule runs its Schedule-IR program through
    ``ir_all_reduce``; ``"xla"`` is the plain sum over the rank axis, sent
    back to every row (the counterpart of ``lax.psum``)."""
    shape = _shape_of(x, shape)
    if schedule == "xla":
        return x.sum(0, keepdim=True).expand_as(x).clone()
    check_schedule(schedule)
    return ir_all_reduce(x, schedule_ir.build_program(schedule, shape))


def check_schedule(schedule: str) -> None:
    """Raise unless ``schedule`` names a collective schedule."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}")


def bit_reversed_index(world: int, device=None) -> torch.Tensor:
    """Bit-reversal of every rank's index over log2(world) bits, ``[W]``:
    after the recursive-halving reduce-scatter rank r holds the contiguous
    payload chunk at position rev(r)."""
    L = _n_levels(world)
    idx = rank_index(world, device)
    rev = torch.zeros_like(idx)
    for b in range(L):
        rev = rev | (((idx >> b) & 1) << (L - 1 - b))
    return rev


def reduce_scatter(x: torch.Tensor, schedule: str, codec=None,
                   shape: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Schedule-dispatched reduce-scatter (sum, no mean) of a rank-stacked
    payload: row r of the result is rank r's shard, at the bit-reversed
    position ``bit_reversed_index`` gives.  The fractal schedule
    reduce-scatters natively with ``codec`` on every hop; every other
    schedule runs its all-reduce and slices (same bytes on the wire as its
    all-reduce, same shard layout out), and ``codec`` is ignored there, as
    in the reference (no other lowering has a wire codec)."""
    check_schedule(schedule)
    if schedule == "fractal":
        _shape_of(x, shape)
        return fractal_reduce_scatter(x, codec)
    W = x.shape[0]
    rev = bit_reversed_index(W, x.device)     # raises unless a power of two
    full = all_reduce(x, schedule, shape)
    return full.reshape(W, W, -1)[rank_index(W, x.device), rev]


def all_gather_flat(shard: torch.Tensor) -> torch.Tensor:
    """Inverse of ``reduce_scatter``'s placement: shards back into the
    original flat order, on every rank (the butterfly all-gather inverts
    the bit-reversed scatter for every schedule, the layout being shared)."""
    return fractal_all_gather(shard)
