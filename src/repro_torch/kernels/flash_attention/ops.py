"""Public flash-attention op: GQA by head index, dispatch by device, and a
backward that recomputes through the plain version.

Port of ``repro/kernels/flash_attention/ops.py``.  ``flash_attention(q, k,
v)`` takes q [B, Tq, Hq, D], k [B, Tk, Hkv, D], v [B, Tk, Hkv, Dv] (D may
differ from Dv; Hq a multiple of Hkv, query head h reading KV head
h // (Hq / Hkv)) and returns [B, Tq, Hq, Dv] in q's dtype.  The reference's
``interpret`` argument is gone: the card has no interpret mode, and the
tile shape belongs to the kernel.

  * CPU tensors  → ``ref.flash_attention_ref`` over heads flattened into
    [B * Hq, T, D] (K and V repeated per query head);
  * CUDA tensors → the hand-written kernels of
    ``csrc/flash_attention.cu`` through ``flash_attention_kernel``, which
    read the [B, T, H, D] layout as it is: bf16 by the wgmma kernel fed
    by TMA ("wgmma", which needs q, k and v to start on 16 bytes and D,
    Dv in multiples of 16), f32 on the CUDA cores ("f32").  The op takes
    what the reference's op takes up to the card's limit, D and Dv <=
    ``MAX_HEAD_DIM``: ``kernel_forward`` zero-pads a bf16 D and Dv up to
    a multiple of 16 (zero columns add nothing to q.k; the scale stays
    1/sqrt(D) of the unpadded D) and slices the output back, and copies
    an input that starts off 16 bytes.  ``flash_attention_kernel`` itself
    stays strict: anything its kernels do not take (a dtype, a head size,
    a pointer off 16 bytes) raises.  Nothing falls back.

The port keeps ``flash_attention_ref``'s semantics everywhere: keys past
Tk never enter the softmax, for non-causal ragged Tk and for causal
Tq > Tk alike (the reference's op pads Tk with zero keys that do, ROADMAP
C2).  A query row that sees no key at all (with a window, rows
i >= Tk + window - 1) gets 0 from the kernel and the mean of every V row
from the plain version; neither is a softmax of anything, and the tests
leave such rows out.

The backward is a ``torch.autograd.Function`` whose backward recomputes
the forward through ``flash_attention_ref`` under ``torch.enable_grad()``
and differentiates that: the reference's ``custom_vjp``, which has no
backward kernel either.  ``LAUNCHES`` counts the forward kernels' launches
and ``PATH_LAUNCHES`` the same launches by kernel (the wrapper adds to
both per launch and nowhere else).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

from .ref import flash_attention_ref

LAUNCHES = 0
PATH_LAUNCHES = {"wgmma": 0, "f32": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 232_448          # bytes of shared memory a block may use (H100)
MAX_HEAD_DIM = 256           # D and Dv on the card (kMaxD of the kernels)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("flash_attention")
    lib.flash_attention_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
           ctypes.c_int, ctypes.c_void_p])
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.flash_attention_smem_bytes.restype = ctypes.c_size_t
    return lib


def _check_shapes(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q [B,Tq,Hq,D], k [B,Tk,Hkv,D] and v [B,Tk,Hkv,Dv] "
                         "are 4-d")
    B, Tq, Hq, D = q.shape
    Bk, Tk, Hkv, Dk = k.shape
    if (Bk, Dk) != (B, D) or tuple(v.shape[:3]) != (B, Tk, Hkv):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")


def check_aligned(*tensors) -> None:
    """Raise ``ValueError`` unless every tensor starts on 16 bytes: the bf16
    kernel reads q, k and v by TMA, whose base addresses must be."""
    for name, t in zip("qkv", tensors):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} starts at {t.data_ptr():#x}, not on 16 "
                             "bytes (TMA); pass a contiguous copy")


def flash_attention_kernel(q, k, v, *, causal: bool = True, window=None,
                           softcap=None, scale=None) -> torch.Tensor:
    """Launch B5 (forward): q [B,Tq,Hq,D], k [B,Tk,Hkv,D], v [B,Tk,Hkv,Dv],
    one dtype (float32 or bfloat16), contiguous on one CUDA device →
    [B,Tq,Hq,Dv] in q's dtype, on the current stream, the scores scaled by
    ``scale`` (default 1/sqrt(D)).  bf16 takes D and Dv in multiples of 16
    up to 256 and q, k, v on 16 bytes; f32 any D and Dv up to 256;
    anything else raises."""
    global LAUNCHES
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_kernel needs CUDA tensors, got q "
                         f"on {q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q {q.dtype}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q dtype {q.dtype} not supported "
                        f"({sorted(map(str, _DTYPE_CODE))})")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    _check_shapes(q, k, v)
    path = "wgmma" if q.dtype == torch.bfloat16 else "f32"
    if path == "wgmma":
        check_aligned(q, k, v)
    B, Tq, Hq, D = q.shape
    Tk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    lib = _lib()
    code = _DTYPE_CODE[q.dtype]
    smem = lib.flash_attention_smem_bytes(D, Dv, code)
    if smem == 0:
        raise ValueError(f"kernel does not take D={D}, Dv={Dv} in {q.dtype}"
                         f" (at most 256; bf16 in multiples of 16)")
    if smem > _MAX_SMEM:
        raise ValueError(f"D={D}, Dv={Dv} needs {smem} B of shared memory "
                         f"(> {_MAX_SMEM})")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    if max(B, Hq, -(-Tq // 128)) > 65535 or \
            max(Tq, Tk) * max(Hq, Hkv) * max(D, Dv) >= 2 ** 31:
        raise ValueError(f"shape too large for the kernel: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    out = torch.empty((B, Tq, Hq, Dv), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Tq,
            Tk, Hq, Hkv, D, Dv, scale, int(bool(causal)),
            0 if window is None else int(window),
            0.0 if softcap is None else float(softcap), code, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed ({path} "
                           f"path, cudaError {err})")
    LAUNCHES += 1
    PATH_LAUNCHES[path] += 1
    return out


def flash_attention_heads_ref(q, k, v, *, causal=True, window=None,
                              softcap=None):
    """``ref.flash_attention_ref`` on the op's [B, T, H, D] layout: heads
    flattened into the batch, K and V repeated for each query head of a
    group (head h reads KV head h // G) → [B, Tq, Hq, Dv]."""
    _check_shapes(q, k, v)
    B, Tq, Hq, D = q.shape
    Tk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = Hq // Hkv
    qf = q.transpose(1, 2).reshape(B * Hq, Tq, D)
    kf = k.transpose(1, 2).repeat_interleave(G, dim=1).reshape(B * Hq, Tk, D)
    vf = v.transpose(1, 2).repeat_interleave(G, dim=1).reshape(B * Hq, Tk,
                                                                Dv)
    out = flash_attention_ref(qf, kf, vf, causal=causal, window=window,
                              softcap=softcap)
    return out.reshape(B, Hq, Tq, Dv).transpose(1, 2).contiguous()


def _ready(t, pad):
    """``t`` contiguous, its last dim zero-padded by ``pad``, starting on
    16 bytes (a fresh allocation does)."""
    t = t.contiguous()
    if pad:
        t = torch.nn.functional.pad(t, (0, pad))
    return t.clone() if t.data_ptr() % 16 else t


def kernel_forward(kernel, q, k, v, *, causal=True, window=None,
                   softcap=None) -> torch.Tensor:
    """The op's forward on the card through ``kernel`` (the signature of
    ``flash_attention_kernel``): any D and Dv up to ``MAX_HEAD_DIM``, any
    strides and offsets.  bf16 D and Dv are zero-padded up to a multiple
    of 16 and the output sliced back; the scale is 1/sqrt(D) of the
    unpadded D.  An input that is not contiguous or starts off 16 bytes
    is copied first."""
    _check_shapes(q, k, v)
    D, Dv = q.shape[3], v.shape[3]
    if max(D, Dv) > MAX_HEAD_DIM:
        raise ValueError(f"D={D}, Dv={Dv}: the card's kernels take D and Dv "
                         f"up to {MAX_HEAD_DIM}")
    step = 16 if q.dtype == torch.bfloat16 else 1
    pd, pv = -D % step, -Dv % step
    out = kernel(_ready(q, pd), _ready(k, pd), _ready(v, pv), causal=causal,
                 window=window, softcap=softcap, scale=1.0 / math.sqrt(D))
    return out[..., :Dv].contiguous() if pv else out


class _FlashAttention(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU).  Backward:
    recompute through the plain version and differentiate it."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap)
        if q.device.type == "cpu":
            return flash_attention_heads_ref(q, k, v, **ctx.opts)
        return kernel_forward(flash_attention_kernel, q, k, v, **ctx.opts)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
            out = flash_attention_heads_ref(qr, kr, vr, **ctx.opts)
            dq, dk, dv = torch.autograd.grad(out, (qr, kr, vr), g)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    softcap=None) -> torch.Tensor:
    """q: [B,Tq,Hq,D], k: [B,Tk,Hkv,D], v: [B,Tk,Hkv,Dv] → [B,Tq,Hq,Dv]
    (GQA by head index), differentiable in q, k and v."""
    return _FlashAttention.apply(q, k, v, causal, window, softcap)


__all__ = ["MAX_HEAD_DIM", "check_aligned", "flash_attention",
           "flash_attention_kernel", "flash_attention_heads_ref",
           "flash_attention_ref", "kernel_forward"]
