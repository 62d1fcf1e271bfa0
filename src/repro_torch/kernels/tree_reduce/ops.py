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

``TREE_SUM_LAUNCHES``, ``INT8_TREE_SUM_LAUNCHES``, ``BF16_LAUNCHES`` and
``INT8_LAUNCHES`` count the kernels' launches (each kernel wrapper adds one
per call that launches and nowhere else), so a run can show that its path
went through the kernels.
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

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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
         ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p])
    lib.tree_sum_launch.restype = ctypes.c_int
    lib.int8_tree_sum_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int64,
                                 ctypes.c_void_p])
    lib.int8_tree_sum_launch.restype = ctypes.c_int
    lib.tree_sum_scratch_rows.argtypes = [ctypes.c_int64]
    lib.tree_sum_scratch_rows.restype = ctypes.c_int64
    return lib


def _scratch(n: int, cols: int, like: torch.Tensor):
    """The f32 scratch rows that tree_sum.cu's passes over n input rows
    need (the first pass's output), or None when one pass does it all."""
    rows = _sum_lib().tree_sum_scratch_rows(n)
    if rows == 0:
        return None
    return torch.empty((rows, cols), dtype=torch.float32, device=like.device)


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
    if x.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise TypeError(f"tree_reduce_kernel takes float32/bfloat16, got x "
                        f"{x.dtype} and out_dtype {out_dtype}")
    if x.ndim != 2 or x.shape[0] < 1:
        raise ValueError(f"x must be [N >= 1, D], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    N, D = x.shape
    out = torch.empty(D, dtype=out_dtype, device=x.device)
    scratch = _scratch(N, D, x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _sum_lib().tree_sum_launch(
            x.data_ptr(), _DTYPE_CODE[x.dtype], out.data_ptr(),
            _DTYPE_CODE[out_dtype],
            0 if scratch is None else scratch.data_ptr(), N, D, stream)
    _launched("tree_sum", err)
    TREE_SUM_LAUNCHES += 1
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
    out = torch.empty(nb * CODEC_BLOCK, dtype=torch.float32, device=q.device)
    scratch = _scratch(N, nb * CODEC_BLOCK, q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _sum_lib().int8_tree_sum_launch(
            q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            0 if scratch is None else scratch.data_ptr(), N, nb, stream)
    _launched("int8_tree_sum", err)
    INT8_TREE_SUM_LAUNCHES += 1
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
           "tree_reduce_kernel", "int8_tree_reduce_kernel",
           "decode_add_bf16_kernel", "decode_add_int8_kernel",
           "tree_reduce_ref", "int8_tree_reduce_ref", "decode_add_bf16",
           "decode_add_int8"]
