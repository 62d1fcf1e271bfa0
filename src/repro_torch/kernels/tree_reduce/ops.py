"""Public tree-reduce ops: the pairwise-tree column sums (B3, B4) and the
codec decode-add (B1, B2), with dispatch by device.

Port of ``repro/kernels/tree_reduce/ops.py``:

  * ``tree_reduce``       — [N, D] → [D], the deterministic pairwise-tree
    sum (B3); N is padded to a power of two with zero rows.
  * ``encode_rows``       — per-row wire encoding of an [N, D] stack.
  * ``coded_tree_reduce`` — the tree sum of N wire-encoded rows → [D] f32:
    ``none``/``bf16`` rows through B3 with an f32 result, ``int8`` rows
    dequantised inside B4.
  * ``decode_add``        — ``keep + decode(wire)`` in one pass (B1, B2):
    the receive side of every reduce hop of the fractal reduce-scatter
    (``core/collectives._codec_exchange_add``).

The reference's ``block``/``interpret`` arguments are gone: the column
blocking never changes a result (each column is summed on its own), and
there is no interpret mode here.  Dispatch follows the tensor's device:

  * CPU tensors  → ``ref.py`` (the rows padded with ``ref.pad_rows``);
  * CUDA tensors → the hand-written kernels of ``csrc/tree_sum.cu`` (B3,
    B4; the zero rows are implicit, never copied) and ``csrc/tree_reduce.cu``
    (B1, B2), or an error.  Nothing falls back.

``tree_sum_path`` picks B3's and B4's kernel before the launch: "ring"
(rows and pointers on 16 bytes: the persistent bulk-copy ring) or
"ragged" (anything else: the grid-stride kernels).  ``tree_sum_tiles``
mirrors the ring's walk on the host (its grid, each block's work items
and every bulk copy), so the CPU tests can check it covers every column
once with copies the hardware takes.

``TREE_SUM_LAUNCHES``, ``INT8_TREE_SUM_LAUNCHES``, ``BF16_LAUNCHES`` and
``INT8_LAUNCHES`` count the kernels' launches (each kernel wrapper adds one
per call that launches and nowhere else), so a run can show that its path
went through the kernels; ``TREE_SUM_LAUNCHES_BY_PATH`` and
``INT8_TREE_SUM_LAUNCHES_BY_PATH`` count the same launches by path.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

from .ref import (CODEC_BLOCK, decode_add_bf16, decode_add_int8,
                  int8_tree_reduce_ref, pad_rows, tree_reduce_ref)

BF16_LAUNCHES = 0
INT8_LAUNCHES = 0
TREE_SUM_LAUNCHES = 0
INT8_TREE_SUM_LAUNCHES = 0
TREE_SUM_LAUNCHES_BY_PATH = {"ring": 0, "ragged": 0}
INT8_TREE_SUM_LAUNCHES_BY_PATH = {"ring": 0, "ragged": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_PATH_CODE = {"ragged": 0, "ring": 1}
_FLOAT_DTYPES = (torch.float32, torch.bfloat16)

# the ring kernel's shapes (csrc/tree_sum.cu: kSlice, kRingBytes): a work
# item loads RING_SLICE_BYTES of each of its 2^L input rows; a block's
# ring holds RING_BYTES of row slices (B4's scales beside them), so
# RING_BYTES / (2^L x RING_SLICE_BYTES) stages
RING_SLICE_BYTES = 8192
RING_BYTES = 192 * 1024
MAX_LEVELS = 3                    # rows a pass halves in registers: 2^3


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("tree_reduce")
    lib.decode_add_bf16_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_void_p])
    lib.decode_add_bf16_launch.restype = ctypes.c_int
    lib.decode_add_int8_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p])
    lib.decode_add_int8_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sum_lib():
    lib = build.load("tree_sum")
    lib.tree_sum_launch.argtypes = (
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
         ctypes.c_void_p])
    lib.tree_sum_launch.restype = ctypes.c_int
    lib.int8_tree_sum_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int64,
                                 ctypes.c_int, ctypes.c_void_p])
    lib.int8_tree_sum_launch.restype = ctypes.c_int
    lib.tree_sum_ring_occupancy.argtypes = (
        [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2)
    lib.tree_sum_ring_occupancy.restype = ctypes.c_int
    return lib


def tree_sum_passes(n: int) -> list:
    """The passes of tree_sum.cu over n input rows, as (levels, input
    rows that exist, output rows): a first pass of up to 3 levels over the
    n rows, then passes of up to 3 levels over the f32 scratch (rows padded
    to max(2, 2^ceil(log2 n)) read as zero and are never loaded)."""
    levels = max(1, (n - 1).bit_length())
    k = min(levels, MAX_LEVELS)
    out, rows_real, rows = [], n, (1 << levels) >> k
    out.append((k, rows_real, rows))
    left = levels - k
    while left:
        k = min(left, MAX_LEVELS)
        out.append((k, rows, rows >> k))
        rows >>= k
        left -= k
    return out


def ring_stages(levels: int) -> int:
    """Stages of the ring at ``levels`` (2^levels row slices a stage)."""
    return RING_BYTES // ((1 << levels) * RING_SLICE_BYTES)


def tree_sum_tiles(N: int, D: int, elem_bytes: int, sms: int,
                   blocks_per_sm: int) -> list:
    """The ring's walk, as csrc/tree_sum.cu computes it, over N rows of D
    elements of ``elem_bytes`` bytes (4 f32, 2 bf16, 1 int8 codes with
    D = nb * 128) on ``sms`` SMs holding ``blocks_per_sm`` blocks each.

    One dict per pass (``tree_sum_passes``; the passes after the first read
    the f32 scratch): ``levels``, ``rows_real``, ``rows_out``,
    ``elem_bytes``, ``tile_cols``, ``tiles``, ``grid`` (every block that
    fits, or one an item), ``stages`` and ``blocks``, a list per block of
    its work items in order: block b takes items b, b + grid, ...  An item
    is a dict: output row ``o``, tile ``t``, first column ``c0``, ``cols``,
    the ring ``stage`` and its ``lap`` (barrier phase), and ``copies``, the
    bulk copies of its input rows as (row, byte offset from the tensor's
    start, bytes), then for B4's first pass ``scale_copies`` the same over
    the scales [N, nb]."""
    passes = []
    for p, (levels, rows_real, rows_out) in enumerate(tree_sum_passes(N)):
        e = elem_bytes if p == 0 else 4
        T = RING_SLICE_BYTES // e
        tiles = -(-D // T)
        items = rows_out * tiles
        grid = min(sms * blocks_per_sm, items)
        stages = ring_stages(levels)
        blocks = []
        for b in range(grid):
            walk = []
            for k, i in enumerate(range(b, items, grid)):
                o, t = divmod(i, tiles)
                c0 = t * T
                cols = min(T, D - c0)
                rows = [r for r in (o + m * rows_out
                                    for m in range(1 << levels))
                        if r < rows_real]
                item = dict(o=o, t=t, c0=c0, cols=cols, stage=k % stages,
                            lap=k // stages,
                            copies=[(r, (r * D + c0) * e, cols * e)
                                    for r in rows])
                if e == 1:
                    nb = D // CODEC_BLOCK
                    item["scale_copies"] = [
                        (r, (r * nb + c0 // CODEC_BLOCK) * 4,
                         cols // CODEC_BLOCK * 4) for r in rows]
                walk.append(item)
            blocks.append(walk)
        passes.append(dict(levels=levels, rows_real=rows_real,
                           rows_out=rows_out, elem_bytes=e, tile_cols=T,
                           tiles=tiles, grid=grid, stages=stages,
                           blocks=blocks))
    return passes


def tree_sum_path(x: torch.Tensor, scale: torch.Tensor = None) -> str:
    """The kernel that ``tree_reduce_kernel`` (x [N, D] f32/bf16) or
    ``int8_tree_reduce_kernel`` (x = q [N, nb, 128] int8 with ``scale``)
    launches: "ring" when every row starts on 16 bytes (f32 D % 4 == 0,
    bf16 D % 8 == 0; int8 nb % 4 == 0, so that the rows of scales do too)
    and x (and scale) start on 16 bytes, so that every bulk copy is
    aligned; else "ragged".  Outputs and scratch are fresh allocations,
    always aligned."""
    if x.dtype == torch.int8:
        ok = x.shape[1] % 4 == 0 and scale.data_ptr() % 16 == 0
    else:
        ok = (x.shape[1] * x.element_size()) % 16 == 0
    return "ring" if ok and x.data_ptr() % 16 == 0 else "ragged"


def ring_occupancy(in_dtype=torch.float32, out_dtype=torch.float32,
                   levels: int = MAX_LEVELS) -> tuple:
    """(SMs, blocks an SM holds) of the ring kernel for ``in_dtype``
    (float32, bfloat16, or int8 for B4's first pass) into ``out_dtype`` at
    ``levels`` on the current CUDA device: the numbers the launcher sizes
    its grid from (``tree_sum_tiles`` takes them)."""
    per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
    err = _sum_lib().tree_sum_ring_occupancy(
        _DTYPE_CODE[in_dtype], _DTYPE_CODE[out_dtype], levels,
        ctypes.byref(per_sm), ctypes.byref(sms))
    _launched("tree_sum_ring_occupancy", err)
    return sms.value, per_sm.value


def _buffers(n: int, cols: int, out_dtype, device):
    """The output [cols] and the f32 scratch that tree_sum.cu's passes over
    n input rows need: the first pass's output rows, or None when one pass
    does it all.  ``chip_smoke.py`` swaps this for guarded buffers."""
    out = torch.empty(cols, dtype=out_dtype, device=device)
    passes = tree_sum_passes(n)
    if len(passes) == 1:
        return out, None
    return out, torch.empty((passes[0][2], cols), dtype=torch.float32,
                            device=device)


def _check(name, keep, **wire):
    dev = keep.device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got keep on {dev}")
    if keep.dtype != torch.float32:
        raise TypeError(f"keep must be float32, got {keep.dtype}")
    for key, t in (("keep", keep), *wire.items()):
        if t.device != dev:
            raise ValueError(f"{key} is on {t.device}, keep on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{key} must be contiguous")


def _launched(name, err):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed (cudaError {err})")


def decode_add_bf16_kernel(keep: torch.Tensor, wire: torch.Tensor
                           ) -> torch.Tensor:
    """Launch B1: keep (f32) + f32(wire (bf16)), contiguous, same element
    count, one CUDA device → a new tensor in keep's shape, on the current
    stream."""
    global BF16_LAUNCHES
    _check("decode_add_bf16_kernel", keep, wire=wire)
    if wire.dtype != torch.bfloat16:
        raise TypeError(f"wire must be bfloat16, got {wire.dtype}")
    if wire.numel() != keep.numel():
        raise ValueError(f"wire has {wire.numel()} elements, keep "
                         f"{keep.numel()}")
    out = torch.empty_like(keep)
    with torch.cuda.device(keep.device):
        stream = torch.cuda.current_stream(keep.device).cuda_stream
        err = _lib().decode_add_bf16_launch(
            keep.data_ptr(), wire.data_ptr(), out.data_ptr(), keep.numel(),
            stream)
    _launched("decode_add_bf16", err)
    BF16_LAUNCHES += 1
    return out


def decode_add_int8_kernel(keep: torch.Tensor, q: torch.Tensor,
                           scale: torch.Tensor) -> torch.Tensor:
    """Launch B2: keep (f32) + f32(q (int8)) * scale per 128-block, one
    rounding.  q has keep's element count (a multiple of 128) and scale one
    f32 per block; all contiguous on one CUDA device → a new tensor in
    keep's shape, on the current stream."""
    global INT8_LAUNCHES
    _check("decode_add_int8_kernel", keep, q=q, scale=scale)
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"q must be int8 and scale float32, got {q.dtype} "
                        f"and {scale.dtype}")
    M = keep.numel()
    if q.numel() != M or M % CODEC_BLOCK or \
            scale.numel() != M // CODEC_BLOCK:
        raise ValueError(f"keep has {M} elements, q {q.numel()}, scale "
                         f"{scale.numel()}: need q == keep, a multiple of "
                         f"{CODEC_BLOCK}, and one scale per block")
    out = torch.empty_like(keep)
    with torch.cuda.device(keep.device):
        stream = torch.cuda.current_stream(keep.device).cuda_stream
        err = _lib().decode_add_int8_launch(
            keep.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            M, stream)
    _launched("decode_add_int8", err)
    INT8_LAUNCHES += 1
    return out


def tree_reduce_kernel(x: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """Launch B3: x [N, D] (f32 or bf16, contiguous, on a CUDA device) →
    [D] in ``out_dtype`` (f32 or bf16; default x's dtype), the pairwise
    tree sum of x padded with zero rows to ``max(2, 2^ceil(log2 N))``.
    Bit for bit ``ref.tree_reduce_ref(ref.pad_rows(x), out_dtype)``."""
    global TREE_SUM_LAUNCHES
    out_dtype = out_dtype or x.dtype
    if x.device.type != "cuda":
        raise ValueError(f"tree_reduce_kernel needs a CUDA tensor, got x on "
                         f"{x.device}")
    if x.dtype not in _FLOAT_DTYPES or out_dtype not in _FLOAT_DTYPES:
        raise TypeError(f"tree_reduce_kernel takes float32/bfloat16, got x "
                        f"{x.dtype} and out_dtype {out_dtype}")
    if x.ndim != 2 or x.shape[0] < 1:
        raise ValueError(f"x must be [N >= 1, D], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    N, D = x.shape
    path = tree_sum_path(x)
    with torch.cuda.device(x.device):
        out, scratch = _buffers(N, D, out_dtype, x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _sum_lib().tree_sum_launch(
            x.data_ptr(), _DTYPE_CODE[x.dtype], out.data_ptr(),
            _DTYPE_CODE[out_dtype],
            0 if scratch is None else scratch.data_ptr(), N, D,
            _PATH_CODE[path], stream)
    _launched(f"tree_sum ({path} path)", err)
    TREE_SUM_LAUNCHES += 1
    TREE_SUM_LAUNCHES_BY_PATH[path] += 1
    return out


def int8_tree_reduce_kernel(q: torch.Tensor, scale: torch.Tensor
                            ) -> torch.Tensor:
    """Launch B4: q [N, nb, 128] int8 + scale [N, nb, 1] f32 (contiguous,
    one CUDA device) → [nb * 128] f32, the tree sum of the dequantised
    rows padded with zero rows as ``tree_reduce_kernel``.  Bit for bit
    ``ref.int8_tree_reduce_ref`` of the padded rows."""
    global INT8_TREE_SUM_LAUNCHES
    if q.device.type != "cuda":
        raise ValueError(f"int8_tree_reduce_kernel needs CUDA tensors, got q "
                         f"on {q.device}")
    if scale.device != q.device:
        raise ValueError(f"scale is on {scale.device}, q on {q.device}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"q must be int8 and scale float32, got {q.dtype} "
                        f"and {scale.dtype}")
    if q.ndim != 3 or q.shape[2] != CODEC_BLOCK or q.shape[0] < 1 or \
            tuple(scale.shape) != (q.shape[0], q.shape[1], 1):
        raise ValueError(f"q must be [N, nb, {CODEC_BLOCK}] and scale "
                         f"[N, nb, 1], got {tuple(q.shape)} and "
                         f"{tuple(scale.shape)}")
    if not (q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("q and scale must be contiguous")
    N, nb, _ = q.shape
    path = tree_sum_path(q, scale)
    with torch.cuda.device(q.device):
        out, scratch = _buffers(N, nb * CODEC_BLOCK, torch.float32, q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _sum_lib().int8_tree_sum_launch(
            q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            0 if scratch is None else scratch.data_ptr(), N, nb,
            _PATH_CODE[path], stream)
    _launched(f"int8_tree_sum ({path} path)", err)
    INT8_TREE_SUM_LAUNCHES += 1
    INT8_TREE_SUM_LAUNCHES_BY_PATH[path] += 1
    return out


def tree_reduce(x: torch.Tensor) -> torch.Tensor:
    """[N, D] → [D] in x's dtype: the deterministic pairwise-tree sum,
    N padded with zero rows to ``1 << max(1, (N - 1).bit_length())`` as
    the reference pads (so N = 1 turns -0.0 into +0.0).  CPU tensors take
    ``ref.tree_reduce_ref``; CUDA tensors launch B3 or raise."""
    if x.device.type == "cpu":
        return tree_reduce_ref(pad_rows(x))
    return tree_reduce_kernel(x.contiguous())


def encode_rows(x: torch.Tensor, codec: str) -> dict:
    """Per-row wire encoding of an [N, D] stack of reduction operands.

    Rows are independent wire messages, so int8 groups run along D:
    q [N, D/128, 128] int8 + scale [N, D/128, 1] f32, with D a multiple of
    128.  The reference runs this eagerly, so both divisions are true
    divisions (not the reciprocal multiply of its jitted codecs), with
    round-half-to-even: codes and scales equal the reference's bit for
    bit."""
    if codec == "none":
        return {"x": x}
    if codec == "bf16":
        return {"x": x.to(torch.bfloat16)}
    if codec == "int8":
        N, D = x.shape
        if D % CODEC_BLOCK:
            raise ValueError(f"D={D} not divisible by {CODEC_BLOCK}")
        xb = x.reshape(N, D // CODEC_BLOCK, CODEC_BLOCK)
        scale = xb.abs().amax(-1, keepdim=True) / 127.0
        safe = torch.where(scale == 0, torch.ones_like(scale), scale)
        q = torch.clamp(torch.round(xb / safe), -127, 127).to(torch.int8)
        return {"q": q, "scale": scale.to(torch.float32)}
    raise ValueError(f"unknown codec {codec!r}")


def _decode_rows(wire: dict, codec: str, dtype) -> torch.Tensor:
    """``encode_rows`` output back to [N, D] rows in ``dtype`` (int8: one
    rounded product per element)."""
    if codec in ("none", "bf16"):
        return wire["x"].to(dtype)
    q, scale = wire["q"], wire["scale"]
    return (q.to(dtype) * scale.to(dtype)).reshape(q.shape[0], -1)


def coded_tree_reduce(wire: dict, codec: str) -> torch.Tensor:
    """The pairwise-tree sum of N wire-encoded rows (``encode_rows``
    output) → [D] f32, the dequantisation inside the reduction: ``none``
    and ``bf16`` rows feed B3's f32 accumulator and come out in f32;
    ``int8`` rows go through B4, whose first level fuses the low row's
    dequant into its add (see ``ref.py``).  CPU tensors take ``ref.py``;
    CUDA tensors launch the kernel or raise."""
    if codec == "int8":
        q, scale = wire["q"], wire["scale"]
        if q.device.type == "cpu":
            return int8_tree_reduce_ref(pad_rows(q), pad_rows(scale))
        return int8_tree_reduce_kernel(q.contiguous(), scale.contiguous())
    if codec not in ("none", "bf16"):
        raise ValueError(f"unknown codec {codec!r}")
    x = wire["x"]
    if x.device.type == "cpu":
        return tree_reduce_ref(pad_rows(_decode_rows(wire, codec,
                                                     torch.float32)))
    return tree_reduce_kernel(x.contiguous(), torch.float32)


def decode_add(keep: torch.Tensor, wire, codec) -> torch.Tensor:
    """``keep + codec.decode(wire)`` in one pass, in keep's shape.

    ``codec`` is an ``optim.compression`` codec; its ``name`` picks the
    kernel: ``"bf16"`` takes ``wire["x"]`` (bf16, keep's element count),
    ``"int8"`` takes ``wire["q"]``/``wire["scale"]`` (the codec's blocks,
    which never straddle a rank's row).  CPU tensors take ``ref.py``; CUDA
    tensors launch the kernel or raise."""
    name = getattr(codec, "name", None)
    if name not in ("bf16", "int8"):
        raise ValueError(f"decode_add has no kernel for codec {name!r}")
    cpu = keep.device.type == "cpu"
    if name == "bf16":
        if cpu:
            return decode_add_bf16(keep, wire["x"])
        return decode_add_bf16_kernel(keep, wire["x"])
    if cpu:
        return decode_add_int8(keep, wire["q"], wire["scale"])
    return decode_add_int8_kernel(keep, wire["q"], wire["scale"])


__all__ = ["tree_reduce", "encode_rows", "coded_tree_reduce", "decode_add",
           "tree_reduce_kernel", "int8_tree_reduce_kernel", "tree_sum_path",
           "tree_sum_passes", "tree_sum_tiles", "ring_stages",
           "ring_occupancy",
           "decode_add_bf16_kernel", "decode_add_int8_kernel",
           "tree_reduce_ref", "int8_tree_reduce_ref", "decode_add_bf16",
           "decode_add_int8"]
