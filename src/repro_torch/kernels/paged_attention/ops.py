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

Both kernels are split-sequence flash-decoding: a split kernel cuts each
row's live pages into chunks of whole pages, one thread block each, and
writes one partial softmax state per chunk in f32; a second kernel
(``csrc/split_merge.cuh``) merges them.  ``plan_splits`` chooses the
number of chunks on the host from shapes alone, never from the lengths
(reading them would be a device-to-host sync, and would break CUDA-graph
capture); each block cuts its row's chunks on the card from the row's
length, as ``split_ranges`` does on the host.

``LAUNCHES`` and ``MLA_LAUNCHES`` count the split kernels' launches,
``MERGE_LAUNCHES`` and ``MLA_MERGE_LAUNCHES`` the merges' (each kernel
wrapper adds one per launch and nowhere else), so a run can show that its
decode path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from repro_torch.kernels import build

from .ref import paged_attention_ref, paged_mla_attention_ref

LAUNCHES = 0
MERGE_LAUNCHES = 0
MLA_LAUNCHES = 0
MLA_MERGE_LAUNCHES = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 232_448          # bytes of shared memory a block may use (H100)
_SM_SMEM = 233_472           # bytes of shared memory an SM's blocks share
# a chunk holds at least this many positions (fewer would spend more on
# its fixed cost and its partial state than on its K/V rows)
MIN_SPLIT_POSITIONS = 32
MAX_SPLITS = 1024            # chunks a row may have (kMaxSplits of the
                             # merge, csrc/split_merge.cuh)
_MAX_PER_SM = 8              # blocks an SM runs at once (B8's f32 kernel:
                             # 256 threads)
_MLA_HEADS = 16              # query heads a block of B8's bf16 kernel takes
_MLA_F32_HEADS = 8           # and of its f32 kernel


def min_split_pages(bs: int) -> int:
    """Pages of ``bs`` positions a chunk holds at least (where its row has
    as many): ``MIN_SPLIT_POSITIONS`` positions."""
    return -(-MIN_SPLIT_POSITIONS // bs)


def plan_splits(B: int, heads: int, n: int, bs: int, sms: int,
                per_sm: int) -> Tuple[int, int]:
    """(splits, pages) for the ``B * heads`` rows of a paged decode grid
    whose tables hold ``n`` pages of ``bs`` positions: ``splits`` chunks a
    row, as many as fill one wave of ``per_sm`` blocks on each of the
    ``sms`` SMs, at most ``MAX_SPLITS`` and no more than n pages can fill
    at ``min_split_pages(bs)`` a chunk; ``pages`` is the most pages any
    chunk of any row can hold (``split_ranges``), which sizes a block's
    table in shared memory.  Takes host integers only, so a plan never
    waits on the card."""
    for name, v in (("B", B), ("heads", heads), ("n", n), ("bs", bs),
                    ("sms", sms), ("per_sm", per_sm)):
        if isinstance(v, bool) or not isinstance(v, int):
            raise TypeError(f"plan_splits takes host ints: {name} is "
                            f"{type(v).__name__}")
        if v < 1:
            raise ValueError(f"plan_splits: {name} = {v} < 1")
    least = min_split_pages(bs)
    want = max(1, min(MAX_SPLITS, per_sm * sms // (B * heads)))
    splits = min(want, -(-n // least))
    return splits, min(n, max(-(-n // splits), least))


def split_ranges(length: int, n: int, bs: int, splits: int,
                 window=None) -> list:
    """The pages [page0, page_end) each of the ``splits`` chunks of one row
    takes on the card (the kernels compute the same from the row's
    ``length``): the live pages, from the window's first position (or 0)
    to the length within the table's ``n`` pages, cut into chunks of
    ceil(live / splits) pages, at least ``min_split_pages(bs)``; a chunk
    past the live pages is empty (page0 >= page_end)."""
    first = max(0, length - window) if window else 0
    p_lo, p_hi = first // bs, -(-min(length, n * bs) // bs)
    chunk = max(-(-(p_hi - p_lo) // splits), min_split_pages(bs))
    return [(p_lo + s * chunk, min(p_lo + (s + 1) * chunk, p_hi))
            for s in range(splits)]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _plan(lib_smem, B, heads, n, bs, device) -> Tuple[int, int]:
    """``plan_splits`` with the SMs of ``device`` and as many blocks a SM
    as the kernel's shared memory (``lib_smem(pages)``) lets in."""
    per_sm = max(1, min(_MAX_PER_SM, _SM_SMEM // (lib_smem(1) + 1024)))
    return plan_splits(B, heads, n, bs, _sm_count(device.index), per_sm)


def _buffers(rows, splits, width, out_shape, dtype, device):
    """The kernels' buffers: the partial states in one f32 workspace, m and
    l [rows, splits] (each padded to 16 bytes) and acc [rows, splits,
    width], and the output."""
    ml = -(-rows * splits // 4) * 4
    ws = torch.empty(2 * ml + rows * splits * width, dtype=torch.float32,
                     device=device)
    out = torch.empty(out_shape, dtype=dtype, device=device)
    return (ws[:ml], ws[ml:2 * ml], ws[2 * ml:]), out


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("paged_attention")
    lib.paged_attention_launch.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
        + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
           ctypes.c_void_p])
    lib.paged_attention_launch.restype = ctypes.c_int
    lib.paged_attention_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.paged_attention_smem_bytes.restype = ctypes.c_size_t
    lib.paged_attention_merge_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.paged_attention_merge_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _mla_lib():
    lib = build.load("paged_mla_attention")
    lib.paged_mla_attention_launch.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.paged_mla_attention_launch.restype = ctypes.c_int
    lib.paged_mla_attention_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.paged_mla_attention_smem_bytes.restype = ctypes.c_size_t
    lib.paged_mla_attention_merge_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.paged_mla_attention_merge_launch.restype = ctypes.c_int
    return lib


def _merge(launch, parts, out, rows, splits, width, code, stream, name):
    err = launch(*(t.data_ptr() for t in parts), out.data_ptr(), rows,
                 splits, width, code, stream)
    if err != 0:
        raise RuntimeError(f"{name} merge launch failed (cudaError {err})")


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
    """Launch the CUDA kernels: q [B, Hkv, G, d], pools [N, bs, Hkv, d(v)],
    tables [B, n] int32, lengths [B] int32, all contiguous on one CUDA
    device → [B, Hkv, G, dv] in q's dtype, on the current stream: the
    split kernel over ``plan_splits`` chunks, then the merge.  Raises on
    anything the kernels do not take; table entries must be valid block
    ids (the kernel does not bounds-check them)."""
    global LAUNCHES, MERGE_LAUNCHES
    _check_kernel_inputs(q, k_pool, v_pool, tables, lengths)
    B, Hkv, G, d = q.shape
    bs, dv = k_pool.shape[1], v_pool.shape[-1]
    n = tables.shape[1]
    lib = _lib()
    code = _DTYPE_CODE[q.dtype]
    smem_of = lambda pages: lib.paged_attention_smem_bytes(G, d, dv, pages,
                                                            code)
    if smem_of(1) == 0:
        raise ValueError(
            f"kernel does not take d={d}, dv={dv} in {q.dtype}: both must "
            f"be multiples of {16 // q.element_size()} elements, at most "
            f"{1024 // q.element_size()}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    if B == 0 or n == 0:
        return torch.zeros((B, Hkv, G, dv), dtype=q.dtype, device=q.device)
    splits, pages = _plan(smem_of, B, Hkv, n, bs, q.device)
    if smem_of(pages) > _MAX_SMEM:
        raise ValueError(f"G={G}, dv={dv}, {pages} pages a split need "
                         f"{smem_of(pages)} B of shared memory "
                         f"(> {_MAX_SMEM})")
    rows = B * Hkv * G
    parts, out = _buffers(rows, splits, dv, (B, Hkv, G, dv), q.dtype,
                          q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_attention_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            tables.data_ptr(), lengths.data_ptr(),
            *(t.data_ptr() for t in parts), B, Hkv, G, d, dv, bs, n, splits,
            pages, min_split_pages(bs), float(scale),
            0 if window is None else int(window),
            0.0 if softcap is None else float(softcap), code, stream)
        if err != 0:
            raise RuntimeError(f"paged_attention kernel launch failed "
                               f"(cudaError {err})")
        LAUNCHES += 1
        _merge(lib.paged_attention_merge_launch, parts, out, rows, splits,
               dv, code, stream, "paged_attention")
        MERGE_LAUNCHES += 1
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
    """Launch the CUDA kernels: q_eff [B, H, r], q_rope [B, H, dr],
    ckv_pool [N, bs, r], kr_pool [N, bs, dr], tables [B, n] int32, lengths
    [B] int32, all contiguous on one CUDA device → [B, H, r] in q_eff's
    dtype, on the current stream: the split kernel over ``plan_splits``
    chunks, then the merge.  Raises on anything the kernels do not take;
    table entries below each length must be valid block ids (the kernel
    does not bounds-check them)."""
    global MLA_LAUNCHES, MLA_MERGE_LAUNCHES
    _check_mla_inputs(q_eff, q_rope, ckv_pool, kr_pool, tables, lengths)
    B, H, r = q_eff.shape
    dr = q_rope.shape[-1]
    bs, n = ckv_pool.shape[1], tables.shape[1]
    lib = _mla_lib()
    code = _DTYPE_CODE[q_eff.dtype]
    smem_of = lambda pages: lib.paged_mla_attention_smem_bytes(r, dr, pages,
                                                                bs, code)
    if smem_of(1) == 0:
        raise ValueError(
            f"kernel does not take r={r}, dr={dr} in {q_eff.dtype}: both "
            f"must be multiples of {4 if code == 0 else 16}, r <= 512, "
            "dr <= 128")
    if B == 0 or H == 0 or n == 0:
        return torch.zeros((B, H, r), dtype=q_eff.dtype, device=q_eff.device)
    heads = -(-H // (_MLA_HEADS if code == 1 else _MLA_F32_HEADS))
    splits, pages = _plan(smem_of, B, heads, n, bs, q_eff.device)
    if smem_of(pages) > _MAX_SMEM:
        raise ValueError(f"a split of {pages} blocks of {bs} needs "
                         f"{smem_of(pages)} B of shared memory "
                         f"(> {_MAX_SMEM})")
    rows = B * H
    parts, out = _buffers(rows, splits, r, (B, H, r), q_eff.dtype,
                          q_eff.device)
    with torch.cuda.device(q_eff.device):
        stream = torch.cuda.current_stream(q_eff.device).cuda_stream
        err = lib.paged_mla_attention_launch(
            q_eff.data_ptr(), q_rope.data_ptr(), ckv_pool.data_ptr(),
            kr_pool.data_ptr(), tables.data_ptr(), lengths.data_ptr(),
            *(t.data_ptr() for t in parts), B, H, r, dr, bs, n, splits,
            pages, min_split_pages(bs), float(scale), code, stream)
        if err != 0:
            raise RuntimeError(f"paged_mla_attention kernel launch failed "
                               f"(cudaError {err})")
        MLA_LAUNCHES += 1
        _merge(lib.paged_mla_attention_merge_launch, parts, out, rows,
               splits, r, code, stream, "paged_mla_attention")
        MLA_MERGE_LAUNCHES += 1
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
           "paged_mla_attention_kernel", "paged_mla_attention_ref",
           "plan_splits", "split_ranges"]
