"""``chip_smoke.py``'s B8 check, run on the CPU against stand-ins.

The CUDA kernel cannot run here, so an emulation of its arithmetic takes
its place: f32 scores over the valid positions only, an unnormalised
softmax whose weights are rounded to the pool dtype before they weight
c_kv, f32 sums, the division by the f32 normaliser last and the output
rounded to q's dtype.  ``phase_mla_kernels`` must pass it in every case
(f32 smoke widths, bf16 full widths at H 4, 16 and 128, NaN in every slot
no row may read) and must reject a kernel that drops one latent block of
the 336-position row in bf16.

The same holds for an emulation of the split kernel (flash-decoding):
as many chunks as ``ops.plan_splits`` plans (132 SMs, 2 blocks an SM, 16
heads a block in bf16 and 8 in f32), each row's pages cut into them as
the kernel cuts them on the card (``ops.split_ranges``), each chunk's
own max, p rounded relative to it, f32 partial states and the
f32 merge.  Two faulty merges must be rejected in bf16: one that drops
the split holding position length-40 of the longest row, one that adds
the splits' states without the e^(m_s - M) rescale.  Run with ``-s`` to
see the readings.
"""

import importlib.util
import math
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.paged_attention import ops, ref

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def emulated_kernel(q_eff, q_rope, ckv_pool, kr_pool, tables, lengths, *,
                    scale):
    c = ref._gather(ckv_pool, tables)
    k = ref._gather(kr_pool, tables)
    ok = torch.arange(c.shape[1])[None, :] < lengths.long()[:, None]
    c = torch.where(ok[:, :, None], c, 0).float()     # never read
    k = torch.where(ok[:, :, None], k, 0).float()
    s = (torch.einsum("bhr,bsr->bhs", q_eff.float(), c)
         + torch.einsum("bhd,bsd->bhs", q_rope.float(), k)) * scale
    s = torch.where(ok[:, None, :], s, -math.inf)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e.to(ckv_pool.dtype).float()
    o = torch.einsum("bhs,bsr->bhr", p, c) / e.sum(-1, keepdim=True)
    return o.to(q_eff.dtype)


def drops_a_block(q_eff, q_rope, ckv_pool, kr_pool, tables, lengths, **kw):
    """In bf16, the longest row loses the latent block holding position
    length-40."""
    if q_eff.dtype == torch.bfloat16:
        ckv_pool = ckv_pool.clone()
        bs = ckv_pool.shape[1]
        b = int(lengths.argmax())
        L = int(lengths[b])
        ckv_pool[tables[b, (L - 40) // bs].long()] = 0
    return emulated_kernel(q_eff, q_rope, ckv_pool, kr_pool, tables,
                           lengths, **kw)


def emulated_split_kernel(q_eff, q_rope, ckv_pool, kr_pool, tables,
                          lengths, *, scale, fault=None):
    """The split kernel's arithmetic: ``plan_splits`` chunks a row, its
    pages cut into them by ``split_ranges``; per chunk its own max m_s, p = e^(s - m_s) rounded to the pool dtype, l_s and
    acc_s in f32; then the merge (m_s = -inf weighs 0).  In bf16,
    ``fault`` "drop" loses the longest row's split that holds position
    length-40, "no_rescale" merges without e^(m_s - M)."""
    B, H, _ = q_eff.shape
    n, bs = tables.shape[1], ckv_pool.shape[1]
    per_block = 16 if q_eff.dtype == torch.bfloat16 else 8
    splits, _ = ops.plan_splits(B, -(-H // per_block), n, bs, 132, 2)
    c = ref._gather(ckv_pool, tables)
    k = ref._gather(kr_pool, tables)
    S_pos = n * bs
    ok = torch.arange(S_pos)[None, :] < lengths.long()[:, None]
    c = torch.where(ok[:, :, None], c, 0).float()     # never read
    k = torch.where(ok[:, :, None], k, 0).float()
    s = (torch.einsum("bhr,bsr->bhs", q_eff.float(), c)
         + torch.einsum("bhd,bsd->bhs", q_rope.float(), k)) * scale
    s = torch.where(ok[:, None, :], s, -math.inf)
    sid = torch.full((B, S_pos), -1, dtype=torch.long)
    for b, L in enumerate(lengths.tolist()):
        for j, (a, z) in enumerate(ops.split_ranges(L, n, bs, splits)):
            if a < z:
                sid[b, a * bs:z * bs] = j
    own = sid[..., None] == torch.arange(splits)       # [B, pos, S]
    s = torch.where(own[:, None], s[..., None], -math.inf)
    m = s.amax(-2)                                     # [B, H, S]
    e = torch.exp(s - torch.where(torch.isinf(m), 0.0, m)[..., None, :])
    p = e.to(ckv_pool.dtype).float()
    acc = torch.einsum("bhcs,bcr->bhsr", p, c)
    l = e.sum(-2)
    w = torch.exp(m - m.amax(-1, keepdim=True))
    if q_eff.dtype == torch.bfloat16 and fault == "no_rescale":
        w = torch.ones_like(m)
    w = torch.where(torch.isinf(m), 0.0, w)
    if q_eff.dtype == torch.bfloat16 and fault == "drop":
        b = int(lengths.argmax())
        w[b, :, sid[b, int(lengths[b]) - 40]] = 0
    A = torch.einsum("bhs,bhsr->bhr", w, torch.where(
        torch.isinf(m)[..., None], 0.0, acc))
    out = A / (w * l).sum(-1, keepdim=True).clamp_min(1e-30)
    return out.to(q_eff.dtype)


class _Ops:
    def __init__(self, fn):
        self.paged_mla_attention_kernel = fn


def test_emulated_kernel_passes_every_case(smoke, capsys):
    worst_abs, worst_rel = smoke.phase_mla_kernels(
        torch, _Ops(emulated_kernel), ref, torch.device("cpu"))
    out = capsys.readouterr().out
    assert out.count("  B8 float32") == 2
    assert out.count("  B8 bfloat16") == 3
    assert "poisoned unused and past-length slots: output unchanged" in out
    assert 0 < worst_abs and worst_rel <= smoke.BF16_ROW_RTOL_F32
    with capsys.disabled():
        print(f"\nemulated B8: worst |err| {worst_abs:.3e}; worst bf16 row "
              f"error {worst_rel:.3e} against f32 ref.py\n{out}")


def test_dropped_block_is_caught_in_bf16(smoke, capsys):
    with pytest.raises(AssertionError, match="bfloat16") as exc:
        smoke.phase_mla_kernels(torch, _Ops(drops_a_block), ref,
                                torch.device("cpu"))
    with capsys.disabled():
        print(f"\n{exc.value}")


def test_emulated_split_kernel_passes_every_case(smoke, capsys):
    worst_abs, worst_rel = smoke.phase_mla_kernels(
        torch, _Ops(emulated_split_kernel), ref, torch.device("cpu"))
    out = capsys.readouterr().out
    assert out.count("  B8 float32") == 2
    assert out.count("  B8 bfloat16") == 3
    assert "poisoned unused and past-length slots: output unchanged" in out
    assert 0 < worst_abs and worst_rel <= smoke.BF16_ROW_RTOL_F32
    with capsys.disabled():
        print(f"\nemulated split B8: worst |err| {worst_abs:.3e}; worst "
              f"bf16 row error {worst_rel:.3e} against f32 ref.py")


@pytest.mark.parametrize("fault", ["drop", "no_rescale"])
def test_faulty_split_merges_are_caught_in_bf16(smoke, capsys, fault):
    def kernel(*args, **kw):
        return emulated_split_kernel(*args, fault=fault, **kw)

    with pytest.raises(AssertionError, match="bfloat16") as exc:
        smoke.phase_mla_kernels(torch, _Ops(kernel), ref,
                                torch.device("cpu"))
    with capsys.disabled():
        print(f"\n{fault}: {exc.value}")


def test_ds_cut_is_the_counted_five_layers(smoke):
    cfg = smoke.ds_config()
    assert cfg.num_layers == 5 and cfg.layer_pattern == \
        ("mla",) * 3 + ("mla_moe",) * 2
    assert (cfg.d_model, cfg.num_heads, cfg.vocab_size) == \
        (7168, 128, 129_280)
    assert cfg.param_count() == 27_304_638_464
