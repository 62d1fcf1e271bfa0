"""FractalSync collectives on a rank-stacked tensor (port of
``repro/core/collectives.py``).

One device holds a whole BSP world: rank ``r``'s payload is row ``r`` of a
``[W, M]`` tensor (the layout ``jax.vmap(fn, axis_name="data")`` gives the
reference).  A point-to-point exchange at butterfly level ``b`` is the row
permutation ``r -> r ^ (1 << b)``; ``rank_index(W)`` takes the place of the
reference's ``flat_index``.  Every schedule applies its steps in order,
staging all sends before the receives, so the results are the reference's
bit for bit:

  * ``fractal_barrier``        — recursive-doubling fsync token;
  * ``fractal_reduce_scatter`` — recursive halving, log2(W) hops, each hop
                                 ONE ``decode_add`` launch over all ranks'
                                 kept halves when a codec rides the wire;
  * ``fractal_all_gather``     — its inverse (recursive doubling);
  * ``fractal_all_reduce``     — the two halves back to back;
  * ``bit_reversed_index``, ``reduce_scatter``, ``all_gather_flat`` — the
    ZeRO-1 shard layout (rank r holds chunk rev(r) after the scatter).

Ring, xy, naive, hierarchical, tree, ``xla`` and the Schedule-IR lowering
(``ir_all_reduce``) need the Schedule IR or a compiler's collective
(ROADMAP A3) and raise.  The world must be a power of two, as in the
reference.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.tree_reduce.ops import decode_add

SCHEDULES = ("fractal", "ring", "xy", "naive", "hierarchical", "tree",
             "xla")


def _ir_missing(name: str):
    return NotImplementedError(
        f"{name} needs the Schedule IR (ROADMAP A3), which the port does "
        "not have yet; only the fractal schedule is ported")


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


def fractal_reduce_scatter(x: torch.Tensor, codec=None) -> torch.Tensor:
    """Reduce-scatter by recursive halving: ``[W, M]`` → ``[W, M/W]``, rank
    r ending with the sum of chunk rev(r) (LSB-first shard order;
    ``fractal_all_gather`` inverts it).  ``codec`` compresses each
    exchanged half on the wire; partial sums are re-quantized per hop."""
    W = x.shape[0]
    L = _n_levels(W)
    _check_payload(x, W)
    for b in range(L):
        keep, send = _halves(x, b)
        x = _codec_exchange_add(keep, send, b, codec)
    return x


def fractal_all_gather(x: torch.Tensor) -> torch.Tensor:
    """Inverse of ``fractal_reduce_scatter`` (all-gather by doubling):
    ``[W, m]`` → ``[W, m*W]``, every row the gathered payload."""
    W = x.shape[0]
    L = _n_levels(W)
    for b in reversed(range(L)):
        x = _join(x, _exchange(x, b), b)
    return x


def fractal_all_reduce(x: torch.Tensor, codec=None) -> torch.Tensor:
    """Recursive halving-doubling all-reduce: the reduce-scatter, then the
    all-gather by doubles with ``codec`` on every exchanged payload."""
    W = x.shape[0]
    L = _n_levels(W)
    _check_payload(x, W)
    x = fractal_reduce_scatter(x, codec)
    for b in reversed(range(L)):
        x = _join(x, _codec_exchange(x, b, codec), b)
    return x


def ring_all_reduce(*args, **kwargs):
    raise _ir_missing("ring_all_reduce")


def xy_all_reduce(*args, **kwargs):
    raise _ir_missing("xy_all_reduce")


def naive_all_reduce(*args, **kwargs):
    raise _ir_missing("naive_all_reduce")


def hierarchical_all_reduce(*args, **kwargs):
    raise _ir_missing("hierarchical_all_reduce")


def ir_all_reduce(*args, **kwargs):
    raise _ir_missing("ir_all_reduce")


def check_schedule(schedule: str) -> None:
    """Raise unless ``schedule`` is one the port lowers (fractal only)."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}")
    if schedule != "fractal":
        raise _ir_missing(f"schedule {schedule!r}")


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


def reduce_scatter(x: torch.Tensor, schedule: str, codec=None
                   ) -> torch.Tensor:
    """Schedule-dispatched reduce-scatter (sum, no mean) of a rank-stacked
    payload: row r of the result is rank r's shard, at the bit-reversed
    position ``bit_reversed_index`` gives.  The reference's other
    schedules all-reduce and slice through the Schedule IR; they raise."""
    check_schedule(schedule)
    return fractal_reduce_scatter(x, codec)


def all_gather_flat(shard: torch.Tensor) -> torch.Tensor:
    """Inverse of ``reduce_scatter``'s placement: shards back into the
    original flat order, on every rank."""
    return fractal_all_gather(shard)
