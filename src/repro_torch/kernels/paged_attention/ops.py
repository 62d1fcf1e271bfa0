"""Public paged-attention decode op: GQA grouping + dispatch by device.

Port of ``repro/kernels/paged_attention/ops.py`` (GQA only; the MLA variant
comes with the MLA architectures).  Decode-only (T == 1), forward-only.

  * CPU tensors  → ``ref.paged_attention_ref`` (gather, then attend);
  * CUDA tensors → the hand-written kernel ``csrc/paged_attention.cu``
    through ``paged_attention_kernel``, or an error.  Nothing falls back.

``LAUNCHES`` counts the kernel's launches (``paged_attention_kernel`` adds
one per launch and nowhere else), so a run can show that its decode path
went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

from .ref import paged_attention_ref

LAUNCHES = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 232_448          # bytes of shared memory a block may use (H100)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("paged_attention")
    lib.paged_attention_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
           ctypes.c_void_p])
    lib.paged_attention_launch.restype = ctypes.c_int
    lib.paged_attention_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.paged_attention_smem_bytes.restype = ctypes.c_size_t
    return lib


def _check_kernel_inputs(q, k_pool, v_pool, tables, lengths):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"paged_attention_kernel needs CUDA tensors, got "
                         f"q on {dev}")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("tables", tables), ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary "
                             "(the kernel loads 16-byte chunks)")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q dtype {q.dtype} not supported "
                        f"({sorted(map(str, _DTYPE_CODE))})")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"pools ({k_pool.dtype}, {v_pool.dtype}) must match "
                        f"q's dtype {q.dtype}")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("tables and lengths must be int32")
    if q.ndim != 4 or k_pool.ndim != 4 or v_pool.ndim != 4:
        raise ValueError("q [B,Hkv,G,d] and pools [N,bs,Hkv,d] are 4-d")
    B, Hkv, G, d = q.shape
    N, bs, hk, dk = k_pool.shape
    if (hk, dk) != (Hkv, d):
        raise ValueError(f"k_pool {tuple(k_pool.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if tuple(v_pool.shape[:3]) != (N, bs, Hkv):
        raise ValueError(f"v_pool {tuple(v_pool.shape)} does not match "
                         f"k_pool {tuple(k_pool.shape)}")
    if tables.ndim != 2 or tables.shape[0] != B:
        raise ValueError(f"tables {tuple(tables.shape)} must be [B={B}, n]")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths {tuple(lengths.shape)} must be [B={B}]")


def paged_attention_kernel(q, k_pool, v_pool, tables, lengths, *,
                           scale: float, window=None, softcap=None):
    """Launch the CUDA kernel: q [B, Hkv, G, d], pools [N, bs, Hkv, d(v)],
    tables [B, n] int32, lengths [B] int32, all contiguous on one CUDA
    device → [B, Hkv, G, dv] in q's dtype, on the current stream.  Raises
    on anything the kernel does not take; table entries must be valid
    block ids (the kernel does not bounds-check them)."""
    global LAUNCHES
    _check_kernel_inputs(q, k_pool, v_pool, tables, lengths)
    B, Hkv, G, d = q.shape
    bs, dv = k_pool.shape[1], v_pool.shape[-1]
    n = tables.shape[1]
    lib = _lib()
    code = _DTYPE_CODE[q.dtype]
    smem = lib.paged_attention_smem_bytes(G, d, dv, bs, code)
    if smem == 0:
        raise ValueError(
            f"kernel does not take d={d}, dv={dv} in {q.dtype}: both must "
            f"be multiples of {16 // q.element_size()} elements, at most "
            f"{1024 // q.element_size()}")
    if smem > _MAX_SMEM:
        raise ValueError(f"G={G}, dv={dv} needs {smem} B of shared memory "
                         f"(> {_MAX_SMEM})")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    out = torch.empty((B, Hkv, G, dv), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_attention_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, Hkv, G, d, dv, bs, n, float(scale),
            0 if window is None else int(window),
            0.0 if softcap is None else float(softcap), code, stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed "
                           f"(cudaError {err})")
    LAUNCHES += 1
    return out


def _lengths(offset, batch: int, device):
    """Per-row valid-key counts from the cache offset (scalar or [B]):
    a query at position ``offset`` attends positions [0, offset]."""
    off = torch.as_tensor(offset, dtype=torch.int32, device=device)
    if off.ndim == 0:
        off = off.expand(batch)
    return (off + 1).to(torch.int32).contiguous()


def paged_attention(q, k_pool, v_pool, tables, offset, *, scale=None,
                    window=None, softcap=None):
    """Fused GQA decode over a paged KV pool.

    q: [B, 1, Hq, d] (single decode query per row), pools
    [N, bs, Hkv, d(v)], tables [B, n] int32, offset scalar or [B] (tokens
    already cached; the query sits at that position) → [B, 1, Hq, dv].
    """
    B, T, Hq, d = q.shape
    if T != 1:
        raise ValueError(f"paged_attention is decode-only (T==1), got T={T}")
    Hkv = k_pool.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qh = q[:, 0].reshape(B, Hkv, G, d)
    lengths = _lengths(offset, B, q.device)
    if q.device.type == "cpu":
        o = paged_attention_ref(qh, k_pool, v_pool, tables, lengths,
                                scale=scale, window=window, softcap=softcap)
    else:
        o = paged_attention_kernel(
            qh.contiguous(), k_pool, v_pool, tables.to(torch.int32), lengths,
            scale=scale, window=window, softcap=softcap)
    return o.reshape(B, 1, Hq, v_pool.shape[-1])


__all__ = ["paged_attention", "paged_attention_kernel",
           "paged_attention_ref"]
