"""Bytes a step's sync kernels need, counted from the layout alone.

The count reads the same work whatever implements the step: the bytes
each codec's decode-add and the error feedback have to move at least
(each input read once, each output written once).  The model's FLOPs are
its family's count (``reference/<family>.py``, ``train_flops``).
"""

from __future__ import annotations

from portbench.reference.bsp import Layout

# bytes a decode-add moves for each element: the f32 partial sum read and
# written, the wire element read, and int8's one f32 scale per 128
DECODE_ADD_BYTES = {"int8": 4 + 1 + 4 / 128 + 4, "bf16": 4 + 2 + 4}
# bytes error feedback moves for each element of a bucket's [world, length]
# rows: the gradient and the residual read, both written back (f32)
ERROR_FEEDBACK_BYTES = 4 * 4


def decode_add_elements(layout: Layout) -> int:
    """Elements every rank decode-adds in one step, summed over ranks: the
    recursive halving adds half of a bucket at the first hop, a quarter at
    the next, ... on each of the W ranks."""
    W = layout.world
    total = 0
    for b in layout.buckets:
        n, m = 0, b.length
        for _ in range(W.bit_length() - 1):
            m //= 2
            n += m
        total += W * n
    return total


def decode_add_bytes(layout: Layout, codec: str) -> float:
    """Least bytes the decode-adds of one step move."""
    return decode_add_elements(layout) * DECODE_ADD_BYTES[codec]


def error_feedback_bytes(layout: Layout) -> float:
    """Least bytes the error feedback of one step moves: every bucket's
    ``[world, length]`` rows."""
    return ERROR_FEEDBACK_BYTES * layout.world * sum(
        b.length for b in layout.buckets)
