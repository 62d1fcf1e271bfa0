"""Public codec decode-add op: ``keep + decode(wire)`` in one launch — the
receive side of every reduce hop of the fractal reduce-scatter
(``core/collectives._codec_exchange_add``).

Port of ``decode_add`` in ``repro/kernels/tree_reduce/ops.py``; the
public ``tree_reduce``/``coded_tree_reduce`` ops (B3, B4) lie on no ported
path and come with a later slice.  Dispatch follows the tensor's device:

  * CPU tensors  → ``ref.decode_add_bf16`` / ``ref.decode_add_int8``;
  * CUDA tensors → the hand-written kernels of ``csrc/tree_reduce.cu``
    through ``decode_add_bf16_kernel`` / ``decode_add_int8_kernel``, or an
    error.  Nothing falls back.

``BF16_LAUNCHES`` and ``INT8_LAUNCHES`` count the kernels' launches (each
kernel wrapper adds one per launch and nowhere else), so a run can show
that its reduce hops went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

from .ref import CODEC_BLOCK, decode_add_bf16, decode_add_int8

BF16_LAUNCHES = 0
INT8_LAUNCHES = 0


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


__all__ = ["decode_add", "decode_add_bf16_kernel", "decode_add_int8_kernel",
           "decode_add_bf16", "decode_add_int8"]
