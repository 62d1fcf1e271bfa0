"""Operations and bytes a step needs, counted from shapes alone.

The count reads the same work whatever implements the step: the model's
FLOPs (a multiply and an add are two), without the forward that
rematerialisation runs again, and the bytes each codec's decode-add has to
move at least (each input read once, the output written once).
"""

from __future__ import annotations

from typing import Dict

from portbench.reference.bsp import Layout
from portbench.reference.lm import ModelSpec

# bytes a decode-add moves for each element: the f32 partial sum read and
# written, the wire element read, and int8's one f32 scale per 128
DECODE_ADD_BYTES = {"int8": 4 + 1 + 4 / 128 + 4, "bf16": 4 + 2 + 4}


def layer_matmul_params(spec: ModelSpec) -> int:
    D, H, Hkv, Dh = spec.d_model, spec.n_heads, spec.n_kv_heads, spec.head_dim
    attn = D * H * Dh + 2 * D * Hkv * Dh + H * Dh * D
    return attn + 3 * D * spec.d_ff


def train_flops(spec: ModelSpec, traffic: dict) -> Dict[str, float]:
    """FLOPs of one training step of the global batch.

    ``matmul``: 6 per matmul parameter per position it is applied at (2
    forward, 4 backward), for the layers and the head.  ``attention``: the score
    and value products over the causal positions (key j <= query i),
    forward 4 * heads * head_dim per pair, backward twice that.
    ``total`` is their sum."""
    B, T = traffic["global_batch"], traffic["seq_len"]
    head = spec.d_model * spec.vocab
    matmul = B * 6 * T * (spec.n_layers * layer_matmul_params(spec) + head)
    pairs = T * (T + 1) // 2
    attention = B * spec.n_layers * 3 * 4 * spec.n_heads * spec.head_dim * pairs
    return {"matmul": float(matmul), "attention": float(attention),
            "total": float(matmul + attention)}


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
