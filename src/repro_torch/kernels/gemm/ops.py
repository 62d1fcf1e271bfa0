"""Public GEMM op, with dispatch by device.

Port of ``repro/kernels/gemm/ops.py``: ``gemm(x, y)`` is ``[M, K] @ [K, N]``
with an f32 accumulator and the output in x's dtype, for any (ragged) M, K
and N.  The reference's ``block_m``/``block_n``/``block_k`` and
``interpret`` arguments are gone: the tile shape belongs to the kernel,
and there is no padding to ask for (the kernel masks its ragged edges).

  * CPU tensors  → ``ref.gemm_ref``;
  * CUDA tensors → the hand-written kernels of ``csrc/gemm.cu`` through
    ``gemm_kernel``, or an error.  Nothing falls back.

``gemm_path`` picks the kernel from the dtype, the shape and the pointers,
before the launch: "wgmma" (bf16, K and N multiples of 8, x and y
16-byte aligned: the warp-specialised wgmma kernel fed by TMA), "mma"
(any other bf16 shape: mma.sync) or "f32" (the CUDA cores, no TF32).
The C launcher runs the kernel it is named and refuses one that does not
take the call.

``LAUNCHES`` counts the kernels' launches and ``PATH_LAUNCHES`` the same
launches by path (the wrapper adds to both per launch and nowhere else).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

from .ref import gemm_ref

LAUNCHES = 0
PATH_LAUNCHES = {"wgmma": 0, "mma": 0, "f32": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_PATH_CODE = {"f32": 0, "mma": 1, "wgmma": 2}


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("gemm")
    lib.gemm_launch.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                                + [ctypes.c_void_p])
    lib.gemm_launch.restype = ctypes.c_int
    return lib


def gemm_path(x: torch.Tensor, y: torch.Tensor) -> str:
    """The kernel that ``gemm_kernel`` launches for x [M, K] @ y [K, N]:
    "f32" for float32; for bfloat16 "wgmma" when K > 0, K and N are
    multiples of 8 and x and y start on 16 bytes (TMA's strides and base),
    else "mma".  The output is a fresh allocation, always aligned."""
    if x.dtype == torch.float32:
        return "f32"
    K, N = x.shape[1], y.shape[1]
    if K > 0 and K % 8 == 0 and N % 8 == 0 and x.data_ptr() % 16 == 0 \
            and y.data_ptr() % 16 == 0:
        return "wgmma"
    return "mma"


def gemm_kernel(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Launch B6: x [M, K] @ y [K, N], both float32 or both bfloat16,
    contiguous on one CUDA device → [M, N] in x's dtype, on the current
    stream."""
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"gemm_kernel needs CUDA tensors, got x on "
                         f"{x.device}")
    if y.device != x.device:
        raise ValueError(f"y is on {y.device}, x on {x.device}")
    if x.dtype not in _DTYPE_CODE or y.dtype != x.dtype:
        raise TypeError(f"gemm_kernel takes two float32 or two bfloat16 "
                        f"matrices, got {x.dtype} and {y.dtype}")
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"shapes {tuple(x.shape)} @ {tuple(y.shape)} are "
                         "not [M, K] @ [K, N]")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("x and y must be contiguous")
    (M, K), N = x.shape, y.shape[1]
    if max(M, N, K) >= 2 ** 31:
        raise ValueError(f"shape {(M, K, N)} too large for the kernel")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    path = gemm_path(x, y)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().gemm_launch(x.data_ptr(), y.data_ptr(), out.data_ptr(),
                                 M, N, K, _DTYPE_CODE[x.dtype],
                                 _PATH_CODE[path], stream)
    if err != 0:
        raise RuntimeError(f"gemm kernel launch failed ({path} path, "
                           f"cudaError {err})")
    LAUNCHES += 1
    PATH_LAUNCHES[path] += 1
    return out


def gemm(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[M, K] @ [K, N] → [M, N] in x's dtype, accumulated in f32.  CPU
    tensors take ``ref.gemm_ref``; CUDA tensors launch B6 or raise."""
    if x.device.type == "cpu":
        return gemm_ref(x, y)
    return gemm_kernel(x.contiguous(), y.contiguous())


__all__ = ["gemm", "gemm_kernel", "gemm_path", "gemm_ref"]
