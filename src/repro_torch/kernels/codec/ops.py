"""Public op of the codec family: error feedback (EF) in one pass, the
``bsp.ef`` phase of the BSP sync, with dispatch by device.

  * ``error_feedback_(g, res, codec)`` — in place on one bucket: the
    rank-stacked gradients g ``[W, L]`` f32 (contiguous) and the bucket's
    residual res ``[W, L]`` f32 (rows any stride apart, columns
    contiguous: a column slice of the train state's ``ef_residual``).
    With x = g + res: res ← x − dequant(quant(x)), g ← x − res.

Dispatch follows the tensors' device, as the other kernel families':

  * CPU tensors  → ``ref.error_feedback_ref_``, the train step's four
    eager lines (which the CPU tests hold to the JAX reference);
  * CUDA tensors → ``csrc/error_feedback.cu``, or an error.  Nothing falls
    back.  The kernel takes ``Bf16Codec`` and ``Int8Codec`` with blocks of
    128 (every config's); another block raises.

``ef_path`` picks the kernel's path before the launch: "vector" (g and
res on 16 bytes, L and res's row stride multiples of 4: 16-byte loads and
stores) or "scalar".  ``ef_plan`` and ``ef_chunks`` mirror the launch on
the host (its grid, and each warp's chunks of 128 elements of a row), so
the CPU tests can check that it covers every element of ``[W, L]`` once.

``EF_LAUNCHES`` counts the kernel's launches by codec and
``EF_LAUNCHES_BY_PATH`` the same launches by path (the wrapper adds one
per call that launches and nowhere else), so a run can show that its EF
went through the kernel: one launch a codec'd bucket a step.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.optim.compression import Bf16Codec, Codec, Int8Codec

from .ref import error_feedback_ref_

EF_LAUNCHES = {"int8": 0, "bf16": 0}
EF_LAUNCHES_BY_PATH = {"vector": 0, "scalar": 0}

# the launch's shape (csrc/error_feedback.cu: kThreads, kMaxBlocks, kChunk)
THREADS = 256
WARPS_PER_BLOCK = THREADS // 32
MAX_BLOCKS = 132 * 8
CHUNK = 128
_CODEC_CODE = {"bf16": 0, "int8": 1}


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("error_feedback")
    lib.error_feedback_launch.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 3 + [ctypes.c_int] * 2
        + [ctypes.c_void_p])
    lib.error_feedback_launch.restype = ctypes.c_int
    return lib


def codec_name(codec: Codec) -> str:
    """"int8" or "bf16": the kernel's codec for a bucket's codec object.
    Raises for a codec it does not take."""
    if isinstance(codec, Int8Codec):
        if codec.block != CHUNK:
            raise ValueError(f"the EF kernel takes int8 blocks of {CHUNK}, "
                             f"got {codec.block}")
        return "int8"
    if isinstance(codec, Bf16Codec):
        return "bf16"
    raise TypeError(f"no EF kernel for codec {codec!r}")


def ef_path(g: torch.Tensor, res: torch.Tensor) -> str:
    """The kernel's path for g [W, L] and res [W, L]: "vector" when both
    start on 16 bytes and L and res's row stride are multiples of 4, so
    that every row of each starts on 16 bytes; else "scalar"."""
    L = g.shape[1]
    ok = (g.data_ptr() % 16 == 0 and res.data_ptr() % 16 == 0
          and L % 4 == 0 and res.stride(0) % 4 == 0)
    return "vector" if ok else "scalar"


def ef_plan(W: int, L: int) -> dict:
    """The launch over [W, L] as the launcher computes it: chunks of
    ``CHUNK`` consecutive elements of a row (a row's last may be shorter),
    ``grid`` blocks of ``WARPS_PER_BLOCK`` warps (every block resident),
    warp w taking chunks w, w + warps, ..."""
    cpr = -(-L // CHUNK)
    chunks = W * cpr
    grid = min(-(-chunks // WARPS_PER_BLOCK), MAX_BLOCKS)
    return dict(W=W, L=L, chunks_per_row=cpr, chunks=chunks, grid=grid,
                warps=grid * WARPS_PER_BLOCK)


def ef_chunks(plan: dict, k: np.ndarray, rstride: int) -> dict:
    """Chunks ``k`` (int64 array) of ``plan`` as the kernel walks them:
    the warp that takes each and its iteration, the row, first column,
    element count and the offsets of the chunk's first element in g and in
    res (whose rows lie ``rstride`` apart)."""
    k = np.asarray(k, dtype=np.int64)
    row = k // plan["chunks_per_row"]
    col = (k - row * plan["chunks_per_row"]) * CHUNK
    return dict(warp=k % plan["warps"], step=k // plan["warps"], row=row,
                col=col, cols=np.minimum(plan["L"] - col, CHUNK),
                g_off=row * plan["L"] + col, r_off=row * rstride + col)


def lane_elements(path: str, cols: int) -> list:
    """Each lane's elements of a chunk of ``cols`` elements: four
    consecutive ones (lane * 4 ...) on the vector path, lane + 32 j on the
    scalar one; elements past ``cols`` are masked."""
    if path == "vector":
        per = [[4 * lane + j for j in range(4)] for lane in range(32)]
    else:
        per = [[lane + 32 * j for j in range(4)] for lane in range(32)]
    return [[e for e in lane if e < cols] for lane in per]


def error_feedback_kernel(g: torch.Tensor, res: torch.Tensor,
                          codec: Codec) -> None:
    """Launch the EF kernel on the current stream: g [W, L] f32,
    contiguous; res [W, L] f32 with contiguous columns, on g's CUDA
    device; ``codec`` a ``Bf16Codec`` or an ``Int8Codec`` of block 128
    (then L % 128 == 0).  Updates both in place."""
    name = codec_name(codec)
    if g.device.type != "cuda":
        raise ValueError(f"error_feedback_kernel needs CUDA tensors, got g "
                         f"on {g.device}")
    if res.device != g.device:
        raise ValueError(f"res is on {res.device}, g on {g.device}")
    if g.dtype != torch.float32 or res.dtype != torch.float32:
        raise TypeError(f"g and res must be float32, got {g.dtype} and "
                        f"{res.dtype}")
    if g.ndim != 2 or tuple(res.shape) != tuple(g.shape):
        raise ValueError(f"g and res must be [W, L] alike, got "
                         f"{tuple(g.shape)} and {tuple(res.shape)}")
    W, L = g.shape
    if not g.is_contiguous() or (L > 1 and res.stride(1) != 1):
        raise ValueError("g must be contiguous and res's columns contiguous")
    if W > 1 and res.stride(0) < L:
        raise ValueError(f"res's rows overlap (stride {res.stride(0)} < "
                         f"{L})")
    if name == "int8" and L % CHUNK:
        raise ValueError(f"int8 EF needs L % {CHUNK} == 0, got L = {L}")
    if g.numel() == 0:
        return
    path = ef_path(g, res)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = _lib().error_feedback_launch(
            g.data_ptr(), res.data_ptr(), W, L, res.stride(0),
            _CODEC_CODE[name], int(path == "vector"), stream)
    if err != 0:
        raise RuntimeError(f"error_feedback ({name}, {path} path) kernel "
                           f"launch failed (cudaError {err})")
    EF_LAUNCHES[name] += 1
    EF_LAUNCHES_BY_PATH[path] += 1


def error_feedback_(g: torch.Tensor, res: torch.Tensor,
                    codec: Codec) -> None:
    """EF in place on one bucket: x = g + res; res ← x − dequant(quant(x))
    under ``codec``; g ← x − res.  CPU tensors take the plain version
    (``ref.error_feedback_ref_``); CUDA tensors launch the kernel or
    raise."""
    if g.device.type == "cpu":
        error_feedback_ref_(g, res, codec)
    else:
        error_feedback_kernel(g, res, codec)
