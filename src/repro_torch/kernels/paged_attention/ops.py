"""Public paged-attention decode ops: GQA grouping (B7) and absorbed MLA
(B8), with dispatch by device.

Port of ``repro/kernels/paged_attention/ops.py``.  Decode-only (T == 1),
forward-only.

  * CPU tensors  → ``ref.paged_attention_ref`` /
    ``ref.paged_mla_attention_ref`` (gather, then attend);
  * CUDA tensors → the hand-written kernels ``csrc/paged_attention.cu``
    (through ``paged_attention_kernel``) and ``csrc/paged_mla_attention.cu``
    (through ``paged_mla_attention_kernel``), or an error.  Nothing falls
    back.

``LAUNCHES`` and ``MLA_LAUNCHES`` count the kernels' launches (each kernel
wrapper adds one per launch and nowhere else), so a run can show that its
decode path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

from .ref import paged_attention_ref, paged_mla_attention_ref

LAUNCHES = 0
MLA_LAUNCHES = 0

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


@functools.lru_cache(maxsize=None)
def _mla_lib():
    lib = build.load("paged_mla_attention")
    lib.paged_mla_attention_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.paged_mla_attention_launch.restype = ctypes.c_int
    lib.paged_mla_attention_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.paged_mla_attention_smem_bytes.restype = ctypes.c_size_t
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


def _check_mla_inputs(q_eff, q_rope, ckv_pool, kr_pool, tables, lengths):
    dev = q_eff.device
    if dev.type != "cuda":
        raise ValueError(f"paged_mla_attention_kernel needs CUDA tensors, "
                         f"got q_eff on {dev}")
    named = (("q_eff", q_eff), ("q_rope", q_rope), ("ckv_pool", ckv_pool),
             ("kr_pool", kr_pool), ("tables", tables), ("lengths", lengths))
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q_eff on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in named[:4]:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary "
                             "(the kernel loads 16-byte chunks)")
        if t.dtype != q_eff.dtype:
            raise TypeError(f"{name} is {t.dtype}, q_eff {q_eff.dtype}: "
                            "the kernel takes one dtype")
    if q_eff.dtype not in _DTYPE_CODE:
        raise TypeError(f"q_eff dtype {q_eff.dtype} not supported "
                        f"({sorted(map(str, _DTYPE_CODE))})")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("tables and lengths must be int32")
    if q_eff.ndim != 3 or q_rope.ndim != 3 or ckv_pool.ndim != 3 \
            or kr_pool.ndim != 3:
        raise ValueError("q_eff [B,H,r], q_rope [B,H,dr] and pools "
                         "[N,bs,r], [N,bs,dr] are 3-d")
    B, H, r = q_eff.shape
    dr = q_rope.shape[-1]
    if tuple(q_rope.shape[:2]) != (B, H):
        raise ValueError(f"q_rope {tuple(q_rope.shape)} does not match "
                         f"q_eff {tuple(q_eff.shape)}")
    N, bs = ckv_pool.shape[:2]
    if ckv_pool.shape[2] != r or tuple(kr_pool.shape) != (N, bs, dr):
        raise ValueError(f"pools {tuple(ckv_pool.shape)}, "
                         f"{tuple(kr_pool.shape)} do not match r={r}, "
                         f"dr={dr}")
    if tables.ndim != 2 or tables.shape[0] != B:
        raise ValueError(f"tables {tuple(tables.shape)} must be [B={B}, n]")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths {tuple(lengths.shape)} must be [B={B}]")


def paged_mla_attention_kernel(q_eff, q_rope, ckv_pool, kr_pool, tables,
                               lengths, *, scale: float):
    """Launch the CUDA kernel: q_eff [B, H, r], q_rope [B, H, dr],
    ckv_pool [N, bs, r], kr_pool [N, bs, dr], tables [B, n] int32, lengths
    [B] int32, all contiguous on one CUDA device → [B, H, r] in q_eff's
    dtype, on the current stream.  Raises on anything the kernel does not
    take; table entries below each length must be valid block ids (the
    kernel does not bounds-check them)."""
    global MLA_LAUNCHES
    _check_mla_inputs(q_eff, q_rope, ckv_pool, kr_pool, tables, lengths)
    B, H, r = q_eff.shape
    dr = q_rope.shape[-1]
    bs, n = ckv_pool.shape[1], tables.shape[1]
    lib = _mla_lib()
    code = _DTYPE_CODE[q_eff.dtype]
    smem = lib.paged_mla_attention_smem_bytes(r, dr, n, bs, code)
    if smem == 0:
        raise ValueError(
            f"kernel does not take r={r}, dr={dr} in {q_eff.dtype}: both "
            f"must be multiples of {4 if code == 0 else 16}, r <= 512, "
            "dr <= 128")
    if smem > _MAX_SMEM:
        raise ValueError(f"a table of n={n} blocks of {bs} per row needs "
                         f"{smem} B of shared memory (> {_MAX_SMEM})")
    out = torch.empty((B, H, r), dtype=q_eff.dtype, device=q_eff.device)
    if B == 0 or H == 0 or n == 0:
        return out.zero_()
    with torch.cuda.device(q_eff.device):
        stream = torch.cuda.current_stream(q_eff.device).cuda_stream
        err = lib.paged_mla_attention_launch(
            q_eff.data_ptr(), q_rope.data_ptr(), ckv_pool.data_ptr(),
            kr_pool.data_ptr(), tables.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), B, H, r, dr, bs, n, float(scale), code, stream)
    if err != 0:
        raise RuntimeError(f"paged_mla_attention kernel launch failed "
                           f"(cudaError {err})")
    MLA_LAUNCHES += 1
    return out


def paged_mla_attention(q_eff, q_rope, ckv_pool, kr_pool, tables, offset, *,
                        scale: float):
    """Absorbed MLA decode over paged latent pools.

    q_eff: [B, 1, H, r] (q_nope·W_uk), q_rope: [B, 1, H, dr], ckv_pool
    [N, bs, r], kr_pool [N, bs, 1, dr] (as cached) or [N, bs, dr], tables
    [B, n], offset scalar or [B] (tokens already cached; the query sits at
    that position) → latent attention output [B, 1, H, r]; the caller
    applies W_uv (a weight contraction, not a cache one).
    """
    B, T, H, r = q_eff.shape
    if T != 1:
        raise ValueError(
            f"paged_mla_attention is decode-only (T==1), got T={T}")
    qe, qr = q_eff[:, 0], q_rope[:, 0]
    kr = kr_pool[:, :, 0, :] if kr_pool.ndim == 4 else kr_pool
    lengths = _lengths(offset, B, q_eff.device)
    if q_eff.device.type == "cpu":
        o = paged_mla_attention_ref(qe, qr, ckv_pool, kr, tables, lengths,
                                    scale=scale)
    else:
        o = paged_mla_attention_kernel(
            qe.contiguous(), qr.contiguous(), ckv_pool, kr,
            tables.to(torch.int32), lengths, scale=scale)
    return o[:, None]


__all__ = ["paged_attention", "paged_attention_kernel",
           "paged_attention_ref", "paged_mla_attention",
           "paged_mla_attention_kernel", "paged_mla_attention_ref"]
