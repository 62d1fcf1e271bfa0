"""``chip_smoke.py``'s kernel check, run on the CPU against stand-ins.

The CUDA kernel cannot run here, so an emulation of its arithmetic takes
its place: f32 scores and softmax over the valid positions only, each
probability rounded to the pool dtype before it weights V, f32 sums and
the output rounded to q's dtype.  ``phase_kernels``, at gemma2-2b's shape
(the first of the smoke run's shapes; the others make the check no
different and cost a minute of CPU), with every length, window and
softcap case, must pass it, and must reject a kernel that drops one V
block of the rows longer than 4096 in bf16, an error of about one bf16
step in absolute terms.

The same holds for an emulation of the split kernel (flash-decoding):
as many chunks as ``ops.plan_splits`` plans (132 SMs, 3 blocks an SM),
each row's live pages cut into them as the kernel cuts them on the card
(``ops.split_ranges``), each chunk's own max, p rounded relative to it,
f32 partial states and the f32 merge.  Two faulty merges must be rejected in
bf16: one that drops a split's state, one that adds the splits' states
without the e^(m_s - M) rescale.  Run with ``-s`` to see the readings.
"""

import importlib.util
import math
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.paged_attention import ops, ref

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def smoke(monkeypatch):
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.KERNEL_SHAPES[0] == dict(Hkv=4, G=2, d=256, bs=16)
    monkeypatch.setattr(mod, "KERNEL_SHAPES", mod.KERNEL_SHAPES[:1])
    return mod


def _valid(lengths, S, window):
    pos = torch.arange(S)[None, :]
    L = lengths.long()[:, None]
    ok = pos < L
    if window is not None:
        ok &= (L - 1 - pos) < window
    return ok                                              # [B, S]


def emulated_kernel(q, k_pool, v_pool, tables, lengths, *, scale,
                    window=None, softcap=None):
    k = ref._gather(k_pool, tables)
    v = ref._gather(v_pool, tables)
    ok = _valid(lengths, k.shape[1], window)
    k = torch.where(ok[:, :, None, None], k, 0).float()   # never read
    v = torch.where(ok[:, :, None, None], v, 0).float()
    s = torch.einsum("bhgd,bshd->bhgs", q.float(), k) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(ok[:, None, None, :], s, -math.inf)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e.to(v_pool.dtype).float()
    o = torch.einsum("bhgs,bshd->bhgd", p, v) / e.sum(-1, keepdim=True)
    return o.to(q.dtype)


def drops_a_v_block(q, k_pool, v_pool, tables, lengths, **kw):
    """In bf16, rows longer than 4096 lose the V rows of the block that
    holds position length-51 (inside every window the smoke run uses)."""
    if q.dtype == torch.bfloat16:
        v_pool = v_pool.clone()
        bs = v_pool.shape[1]
        for b, L in enumerate(lengths.tolist()):
            if L > 4096:
                v_pool[tables[b, (L - 51) // bs].long()] = 0
    return emulated_kernel(q, k_pool, v_pool, tables, lengths, **kw)


def merge_splits(m, l, acc, *, drop=None, rescale=True):
    """The merge kernel: m, l [..., S], acc [..., S, dv] → [..., dv] f32;
    ``drop`` [..., S] bool zeroes those splits' weights, and without
    ``rescale`` the states are added as they are."""
    empty = torch.isinf(m)
    M = m.amax(-1, keepdim=True)
    w = torch.exp(m - torch.where(torch.isinf(M), 0.0, M)) if rescale \
        else torch.ones_like(m)
    w = torch.where(empty, 0.0, w)
    if drop is not None:
        w = torch.where(drop, 0.0, w)
    A = torch.einsum("...s,...sd->...d", w, torch.where(
        empty[..., None], 0.0, acc))
    return A / (w * l).sum(-1, keepdim=True).clamp_min(1e-30)


def split_ids(lengths, n, bs, splits, window=None):
    """[B, n * bs]: the chunk of its row each position falls in on the card
    (``ops.split_ranges``), -1 outside every chunk."""
    sid = torch.full((len(lengths), n * bs), -1, dtype=torch.long)
    for b, L in enumerate(lengths.tolist()):
        for s, (a, e) in enumerate(ops.split_ranges(L, n, bs, splits,
                                                    window)):
            if a < e:
                sid[b, a * bs:e * bs] = s
    return sid


def emulated_split_kernel(q, k_pool, v_pool, tables, lengths, *, scale,
                          window=None, softcap=None, fault=None):
    """The split kernel's arithmetic: ``plan_splits`` chunks a row, its
    live pages cut into them by ``split_ranges``; per chunk its own max
    m_s, p = e^(s - m_s) rounded to the pool dtype, l_s and acc_s in f32;
    then the merge.  In bf16, ``fault`` "drop" loses the state of the
    split holding each long row's last position, "no_rescale" merges
    without e^(m_s - M)."""
    B, Hkv, G, d = q.shape
    n, bs = tables.shape[1], k_pool.shape[1]
    splits, _ = ops.plan_splits(B, Hkv, n, bs, 132, 3)
    k = ref._gather(k_pool, tables)
    v = ref._gather(v_pool, tables)
    S_pos = n * bs
    ok = _valid(lengths, S_pos, window)
    k = torch.where(ok[:, :, None, None], k, 0).float()   # never read
    v = torch.where(ok[:, :, None, None], v, 0).float()
    s = torch.einsum("bhgd,bshd->bhgs", q.float(), k) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(ok[:, None, None, :], s, -math.inf)
    sid = split_ids(lengths, n, bs, splits, window)
    own = sid[..., None] == torch.arange(splits)            # [B,pos,S]
    s = torch.where(own[:, None, None], s[..., None], -math.inf)
    m = s.amax(-2)                                          # [B,H,G,S]
    e = torch.exp(s - torch.where(torch.isinf(m), 0.0, m)[..., None, :])
    p = e.to(v_pool.dtype).float()
    acc = torch.einsum("bhgcs,bchd->bhgsd", p, v)
    l = e.sum(-2)
    drop, rescale = None, True
    if q.dtype == torch.bfloat16 and fault == "drop":
        last = sid[torch.arange(B), lengths.long() - 1][:, None, None, None]
        drop = (torch.arange(splits) == last) & \
            (lengths.long() > 4096)[:, None, None, None]
    if q.dtype == torch.bfloat16 and fault == "no_rescale":
        rescale = False
    out = merge_splits(m, l, acc, drop=drop, rescale=rescale)
    return out.to(q.dtype)


class _Ops:
    def __init__(self, fn):
        self.paged_attention_kernel = fn


def test_emulated_kernel_passes_every_case(smoke, capsys):
    worst_abs, worst_rel = smoke.phase_kernels(
        torch, _Ops(emulated_kernel), ref, torch.device("cpu"))
    out = capsys.readouterr().out
    assert out.count("  B7 float32") == out.count("  B7 bfloat16") == 6
    assert "poisoned masked slots: output unchanged" in out
    assert 0 < worst_abs and worst_rel <= smoke.BF16_ROW_RTOL
    rel32 = max(float(line.split("in f32 ")[1].split()[0])
                for line in out.splitlines() if "in f32 " in line)
    with capsys.disabled():
        print(f"\nemulated kernel: worst |err| {worst_abs:.3e}; worst bf16 "
              f"row error {worst_rel:.3e} against bf16 ref.py, "
              f"{rel32:.3e} against f32 ref.py")


def test_dropped_v_block_is_caught_in_bf16(smoke, capsys):
    with pytest.raises(AssertionError, match="bfloat16") as exc:
        smoke.phase_kernels(torch, _Ops(drops_a_v_block), ref,
                            torch.device("cpu"))
    with capsys.disabled():
        print(f"\n{exc.value}")


def test_emulated_split_kernel_passes_every_case(smoke, capsys):
    worst_abs, worst_rel = smoke.phase_kernels(
        torch, _Ops(emulated_split_kernel), ref, torch.device("cpu"))
    out = capsys.readouterr().out
    assert out.count("  B7 float32") == out.count("  B7 bfloat16") == 6
    assert "poisoned masked slots: output unchanged" in out
    assert 0 < worst_abs and worst_rel <= smoke.BF16_ROW_RTOL
    with capsys.disabled():
        print(f"\nemulated split kernel: worst |err| {worst_abs:.3e}; "
              f"worst bf16 row error {worst_rel:.3e} against bf16 ref.py")


@pytest.mark.parametrize("fault", ["drop", "no_rescale"])
def test_faulty_split_merges_are_caught_in_bf16(smoke, capsys, fault):
    def kernel(*args, **kw):
        return emulated_split_kernel(*args, fault=fault, **kw)

    with pytest.raises(AssertionError, match="bfloat16") as exc:
        smoke.phase_kernels(torch, _Ops(kernel), ref, torch.device("cpu"))
    with capsys.disabled():
        print(f"\n{fault}: {exc.value}")



def guard_stand_in(q, k_pool, v_pool, tables, lengths, *, fault=None,
                   **kw):
    """A CPU stand-in of B7's wrapper that takes its buffers from
    ``ops._buffers`` as the wrapper does and fills them: every partial m
    and l (every other split empty), the live splits' acc, the output
    (the split emulation's).  ``fault`` makes it write one element past
    its output, leave one partial m unwritten, or change q in place."""
    B, Hkv, G, _ = q.shape
    dv = v_pool.shape[-1]
    splits = 3
    (m, l, acc), out = ops._buffers(B * Hkv * G, splits, dv,
                                    (B, Hkv, G, dv), q.dtype, q.device)
    states = B * Hkv * G * splits
    live = torch.arange(states) % 2 == 0
    m[:states - (fault == "unset_m")] = torch.where(
        live, 0.0, -math.inf)[:states - (fault == "unset_m")]
    l[:states] = 1.0
    acc.view(states, dv)[live] = 0.0
    out.copy_(emulated_split_kernel(q, k_pool, v_pool, tables, lengths,
                                    **kw))
    if fault == "past_out" and out.storage_offset():   # room past it
        out.view(-1).as_strided((out.numel() + 1,), (1,))[-1] = 0
    if fault == "input":
        q.view(-1)[0] += 1
    return out


@pytest.mark.parametrize("fault", [None, "past_out", "unset_m", "input"])
def test_guarded_run_catches_stray_writes(smoke, monkeypatch, fault):
    """chip_smoke's guard-byte check of B7/B8, on the CPU around a
    stand-in: a clean one passes; one that writes past its output, leaves
    a partial state unwritten or changes its input is caught."""
    import numpy as np
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    for dtype in (torch.float32, torch.bfloat16):
        inputs = smoke._paged_inputs(
            torch, np.random.default_rng(0), lengths=[40, 17, 1], Hkv=2,
            G=2, d=16, bs=8, dtype=dtype, dev=torch.device("cpu"))
        kernel = lambda *a: guard_stand_in(*a, fault=fault, scale=0.25)
        if fault is None:
            smoke._guarded_run(torch, ops, kernel, inputs, "clean")
            continue
        want = {"past_out": "a write past out", "unset_m":
                "a partial m or l not written", "input": "input 0"}[fault]
        with pytest.raises(AssertionError, match=want):
            smoke._guarded_run(torch, ops, kernel, inputs, fault)


def test_span_counts_overlapping_kernels_once(smoke):
    """The decode profile's device time is the union of the kernels'
    intervals: a merge launched early, whose interval starts inside the
    split kernel's, is not counted twice; gaps are not counted."""
    from types import SimpleNamespace as NS
    ev = lambda a, b: NS(time_range=NS(start=a, end=b))
    assert smoke._span_us([]) == 0
    assert smoke._span_us([ev(0, 10), ev(4, 13), ev(20, 25)]) == 18
    assert smoke._span_us([ev(20, 25), ev(0, 30), ev(2, 3)]) == 30
