"""``chip_smoke.py``'s kernel check, run on the CPU against stand-ins.

The CUDA kernel cannot run here, so an emulation of its arithmetic takes
its place: f32 scores and softmax over the valid positions only, each
probability rounded to the pool dtype before it weights V, f32 sums and
the output rounded to q's dtype.  ``phase_kernels``, at gemma2-2b's shape
(the first of the smoke run's shapes; the others make the check no
different and cost a minute of CPU), with every length, window and
softcap case, must pass it, and must reject a kernel that drops one V
block of the rows longer than 4096 in bf16, an error of about one bf16
step in absolute terms.  Run with ``-s`` to see the readings.
"""

import importlib.util
import math
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.paged_attention import ref

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
