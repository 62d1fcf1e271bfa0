"""The host side of B3/B4's ring kernel (``csrc/tree_sum.cu``), which the
CPU can check although the kernel runs only on the card.

``ops.tree_sum_tiles`` mirrors the ring's walk as the launcher and the
kernel compute it: the passes, the grid from the occupancy, each block's
(output row, column tile) work items (block b takes items b, b + grid,
...), their ring stage and lap, and every bulk copy.  These tests hold it to:

  * every column of every output row of every pass written exactly once,
    each item loading exactly the input rows the pass pairs with its
    output row (rows past the real ones never loaded), and the in-place
    passes reading a tile of an output row only in the item that writes
    it (so a producer running ahead reads nothing already written);
  * every bulk copy (codes, rows and B4's scales) 16-byte aligned in
    address and size, and no larger than a ring slot;
  * each pass plan of ``chip_smoke.TREE_NS`` walked, with the wrap of the
    ring on a block's items;
  * ``ops.tree_sum_path`` choosing the ring exactly when rows and
    pointers are on 16 bytes, for each dtype, D and pointer offset.

And B4's code conversion without I2F (the biased byte in the mantissa of
2^23, minus 2^23 + 128) equal to ``float(q)`` for all 256 codes.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.tree_reduce import ops

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke_for_plan",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

# (SMs, blocks an SM holds): a tiny card, so small D wraps the ring, and
# the H100's 132 SMs at the ring's one block an SM
GRIDS = [(3, 1), (2, 2), (132, 1)]
ELEM = {"f32": 4, "bf16": 2, "int8": 1}


def _ds(elem_bytes):
    """Widths at the tile's edges (one 16-byte step each side) and a few
    tiles with a short last one; int8 widths are whole groups of 4 codec
    blocks (512 codes)."""
    tile = ops.RING_SLICE_BYTES // elem_bytes
    step = 16 // elem_bytes if elem_bytes > 1 else 512
    return [step, tile - step, tile, tile + step, 3 * tile + 5 * step]


def _check_walk(N, D, elem_bytes, sms, per_sm):
    passes = ops.tree_sum_tiles(N, D, elem_bytes, sms, per_sm)
    assert [(p["levels"], p["rows_real"], p["rows_out"]) for p in passes] \
        == ops.tree_sum_passes(N)
    for i, p in enumerate(passes):
        e, T, rows_out = p["elem_bytes"], p["tile_cols"], p["rows_out"]
        assert T * e == ops.RING_SLICE_BYTES
        assert p["grid"] == min(sms * per_sm, rows_out * p["tiles"])
        lens = [len(b) for b in p["blocks"]]
        assert min(lens) >= 1 and max(lens) - min(lens) <= 1
        written = np.zeros((rows_out, D), np.int64)
        loaded = {}                                   # (row, tile) -> item
        items = [it for b in p["blocks"] for it in b]
        assert len(items) == rows_out * p["tiles"]
        for bi, b in enumerate(p["blocks"]):
            for k, it in enumerate(b):
                assert it["o"] * p["tiles"] + it["t"] == bi + k * p["grid"]
                assert (it["stage"], it["lap"]) == divmod(k, p["stages"])[::-1]
        for it in items:
            o, t, c0, cols = it["o"], it["t"], it["c0"], it["cols"]
            assert c0 == t * T and 0 < cols <= T and c0 + cols <= D
            written[o, c0:c0 + cols] += 1
            want_rows = [o + m * rows_out for m in range(1 << p["levels"])
                         if o + m * rows_out < p["rows_real"]]
            assert [r for r, _, _ in it["copies"]] == want_rows
            for r, off, nbytes in it["copies"]:
                assert off == (r * D + c0) * e and nbytes == cols * e
                assert (r, t) not in loaded        # each tile loaded once
                loaded[(r, t)] = (o, t)
        assert (written == 1).all()
        in_place = 0 < i < len(passes) - 1
        if in_place:
            # an output tile (o, t) is loaded only by the item that
            # writes it, so no item reads what another wrote
            for (r, t), by in loaded.items():
                if r < rows_out:
                    assert by == (r, t)
    return passes


@pytest.mark.parametrize("N", smoke.TREE_NS)
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_walk_covers_every_column_once(N, kind):
    e = ELEM[kind]
    for D in _ds(e):
        for sms, per_sm in GRIDS:
            _check_walk(N, D, e, sms, per_sm)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("N", [1, 8, 100])
def test_every_bulk_copy_is_aligned(kind, N):
    e = ELEM[kind]
    for D in _ds(e):
        for p in ops.tree_sum_tiles(N, D, e, 3, 1):
            for it in (it for b in p["blocks"] for it in b):
                copies = it["copies"] + it.get("scale_copies", [])
                assert copies
                for _, off, nbytes in copies:
                    assert off % 16 == 0 and nbytes % 16 == 0
                    assert 0 < nbytes <= ops.RING_SLICE_BYTES


def test_int8_scale_copies_follow_the_codes():
    """B4's first pass copies the scales of exactly the codec blocks of
    its codes' columns, for the same rows; later passes read f32 scratch
    and copy no scales."""
    nb = 3 * 64 + 4                                  # a short last tile
    passes = ops.tree_sum_tiles(20, nb * 128, 1, 2, 1)
    for it in (it for b in passes[0]["blocks"] for it in b):
        rows = [r for r, _, _ in it["copies"]]
        assert [r for r, _, _ in it["scale_copies"]] == rows
        for r, off, nbytes in it["scale_copies"]:
            assert off == (r * nb + it["c0"] // 128) * 4
            assert nbytes == it["cols"] // 128 * 4
    assert all("scale_copies" not in it for p in passes[1:]
               for b in p["blocks"] for it in b)


@pytest.mark.parametrize("N", smoke.TREE_NS)
def test_each_pass_plan_of_the_smoke_cases(N):
    """Every pass plan phase 2 runs: levels summing to log2 of the padded
    rows, the first pass over the N real rows, the last into one row; at
    8 rows over enough tiles every block wraps its ring more than once."""
    passes = ops.tree_sum_passes(N)
    assert sum(k for k, _, _ in passes) == max(1, (N - 1).bit_length())
    assert passes[0][1] == N and passes[-1][2] == 1
    assert all(1 <= k <= ops.MAX_LEVELS for k, _, _ in passes)
    for (_, _, out), (_, real, _) in zip(passes, passes[1:]):
        assert out == real
    if N == 8:
        sms, per_sm = 3, 1
        tile = ops.RING_SLICE_BYTES // 4
        D = tile * (2 * ops.ring_stages(3) + 1) * sms * per_sm
        p = _check_walk(N, D, 4, sms, per_sm)[0]
        assert min(len(b) for b in p["blocks"]) > 2 * p["stages"]


def _path_rule(kind, D, off_bytes, scale_off_bytes=0):
    """The ring takes rows and pointers on 16 bytes (int8: whole groups of
    four codec blocks, so that rows of scales start on 16 bytes too)."""
    if kind == "int8":
        return "ring" if (D // 128) % 4 == 0 and off_bytes % 16 == 0 and \
            scale_off_bytes % 16 == 0 else "ragged"
    return "ring" if (D * ELEM[kind]) % 16 == 0 and off_bytes % 16 == 0 \
        else "ragged"


def _view(shape, dtype, off):
    """A contiguous tensor of ``shape`` starting ``off`` elements into a
    fresh buffer."""
    n = int(np.prod(shape))
    return torch.zeros(n + off, dtype=dtype)[off:].view(shape)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("D", [1, 4, 6, 8, 700, 1024, 2056, 300_001])
@pytest.mark.parametrize("off", [0, 1, 2, 4, 8])
def test_tree_sum_path_by_dtype_width_and_offset(kind, D, off):
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[kind]
    x = _view((3, D), dtype, off)
    assert x.is_contiguous()
    assert ops.tree_sum_path(x) == _path_rule(kind, D, x.data_ptr() % 16)


@pytest.mark.parametrize("nb", [1, 3, 4, 31, 32, 36, 1100])
@pytest.mark.parametrize("off,scale_off", [(0, 0), (16, 0), (0, 1), (8, 0)])
def test_tree_sum_path_int8(nb, off, scale_off):
    q = _view((5, nb, 128), torch.int8, off)
    scale = _view((5, nb, 1), torch.float32, scale_off)
    assert ops.tree_sum_path(q, scale) == _path_rule(
        "int8", nb * 128, q.data_ptr() % 16, scale.data_ptr() % 16)


def exact_codes(q: torch.Tensor) -> torch.Tensor:
    """B4's conversion as the ring kernel computes it: the biased byte
    q + 128 (q ^ 0x80) as the low mantissa byte of 2^23 (0x4B000000),
    minus 2^23 + 128, in f32."""
    biased = (q.to(torch.int32) & 0xFF) ^ 0x80
    magic = (biased | 0x4B000000).view(torch.float32)
    return magic - torch.tensor(8388736.0, dtype=torch.float32)


def test_int8_conversion_without_i2f_is_exact():
    q = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    got = exact_codes(q)
    assert torch.equal(got.view(torch.int32), q.float().view(torch.int32))
    # the same trick at 2^24 rounds odd biased bytes: a conversion that
    # rounds is visible
    biased = ((q.to(torch.int32) & 0xFF) ^ 0x80).float()
    rounded = (torch.tensor(2.0 ** 24) + biased) - (2.0 ** 24 + 128)
    assert not torch.equal(rounded, q.float())
