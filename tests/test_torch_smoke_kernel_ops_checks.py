"""``chip_smoke.py``'s checks of B3-B6 and the public kernel ops, run on the
CPU against stand-ins.

The CUDA kernels cannot run here, so stand-ins take their places and count
their calls as the kernel wrappers count launches:

  * B3/B4: the plain versions themselves (``phase_tree_kernels`` must find
    them bit-identical), and a sum in linear order, which it must reject;
  * B6: the plain version behind ``ops.gemm_path`` (passes, at the full
    widths with gemma's rows cut to 64; every case on its path), one that
    drops a K tile of 32, which the bf16 row check must reject, and one
    that sends the timed shape to the mma kernel, which the path check
    must reject;
  * B5: an emulation of the kernel's arithmetic (f32 scores over the
    visible keys only, each probability rounded to v's dtype before it
    weights V, f32 normaliser, the output rounded once, 0 for a row that
    sees no key), which must pass every case, the padding cases and the
    windowed rows without keys at full size and cases (a)-(c) cut to CPU
    size; and a kernel that lets zero keys padded to a multiple of 128 into
    the softmax, as the reference's op does, which must fail the first
    padding case.
  * The ops path (``phase_kernel_ops``) at small shapes: each op's count
    must come out as the phase asserts, and an int8 sum that leaves
    finite garbage past its first sweep must fail the bit-for-bit check.

Run with ``-s`` to see the readings.
"""

import importlib.util
import math
import types
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fops, ref as fref
from repro_torch.kernels.gemm import ops as gops, ref as gref
from repro_torch.kernels.tree_reduce import ops as tops, ref as tref

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def no_sync(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)


def _counting(ns, count, fn):
    def wrapped(*args, **kw):
        setattr(ns, count, getattr(ns, count) + 1)
        return fn(*args, **kw)
    return wrapped


def _tree_stand_in(tree_sum=None):
    ns = types.SimpleNamespace(TREE_SUM_LAUNCHES=0, INT8_TREE_SUM_LAUNCHES=0,
                               encode_rows=tops.encode_rows)
    ns.tree_reduce_kernel = _counting(
        ns, "TREE_SUM_LAUNCHES", tree_sum or (
            lambda x, od=None: tref.tree_reduce_ref(tref.pad_rows(x), od)))
    ns.int8_tree_reduce_kernel = _counting(
        ns, "INT8_TREE_SUM_LAUNCHES",
        lambda q, s: tref.int8_tree_reduce_ref(tref.pad_rows(q),
                                               tref.pad_rows(s)))
    return ns


def _linear_order(x, od=None):
    acc = x[0].float()
    for i in range(1, x.shape[0]):
        acc = acc + x[i].float()
    return acc.to(od or x.dtype)


def test_tree_check_passes_the_plain_versions(smoke, no_sync, capsys):
    stand_in = _tree_stand_in()
    worst = smoke.phase_tree_kernels(torch, stand_in, tref, CPU)
    assert worst == {"tree_reduce": 0.0, "int8_tree_reduce": 0.0}
    n = len(smoke.TREE_NS)
    assert stand_in.TREE_SUM_LAUNCHES == n * len(smoke.TREE_DS) * 4
    assert stand_in.INT8_TREE_SUM_LAUNCHES == n * len(smoke.INT8_TREE_NBS)
    assert capsys.readouterr().out.count("bit-identical") == \
        n * (len(smoke.TREE_DS) + 1)


def test_tree_check_rejects_a_linear_order_sum(smoke, no_sync):
    with pytest.raises(AssertionError, match="B3 N=.* differs"):
        smoke.phase_tree_kernels(torch, _tree_stand_in(_linear_order), tref,
                                 CPU)


def _gemm_cases(smoke):
    first = dict(smoke.GEMM_CASES[0], M=64)
    return [first] + smoke.GEMM_CASES[1:]


def _counting_paths(ns, path_of, fn):
    """``fn`` counted in ``ns.LAUNCHES`` and in ``ns.PATH_LAUNCHES`` under
    ``path_of(*args)``, as the wrappers count."""
    def wrapped(*args, **kw):
        ns.LAUNCHES += 1
        ns.PATH_LAUNCHES[path_of(*args)] += 1
        return fn(*args, **kw)
    return wrapped


def _gemm_stand_in(fn, path_of=gops.gemm_path):
    ns = types.SimpleNamespace(LAUNCHES=0, PATH_LAUNCHES=dict.fromkeys(
        gops.PATH_LAUNCHES, 0))
    ns.gemm_kernel = _counting_paths(ns, path_of, fn)
    return ns


def test_gemm_check_passes_the_plain_version(smoke, no_sync, capsys):
    stand_in = _gemm_stand_in(gref.gemm_ref)
    err, rel = smoke.phase_gemm_kernels(torch, stand_in, gref, CPU,
                                        cases=_gemm_cases(smoke))
    assert err == 0.0 and rel == 0.0
    assert stand_in.LAUNCHES == len(smoke.GEMM_CASES)
    want = {p: sum(c["path"] == p for c in smoke.GEMM_CASES)
            for p in gops.PATH_LAUNCHES}
    assert stand_in.PATH_LAUNCHES == want and want["mma"] >= 2
    print(capsys.readouterr().out)


def test_gemm_check_rejects_the_timed_shape_on_the_mma_path(smoke, no_sync):
    """A GEMM whose aligned shapes still go to the mma.sync kernel: right
    numbers, wrong kernel."""
    def no_wgmma(x, y):
        path = gops.gemm_path(x, y)
        return "mma" if path == "wgmma" else path

    with pytest.raises(AssertionError, match="not by one on the wgmma path"):
        smoke.phase_gemm_kernels(torch, _gemm_stand_in(gref.gemm_ref,
                                                       no_wgmma),
                                 gref, CPU, cases=_gemm_cases(smoke))


def test_gemm_check_rejects_a_dropped_k_tile(smoke, no_sync):
    def dropped(x, y):
        x = x.clone()
        x[:, 32:64] = 0
        return gref.gemm_ref(x, y)

    with pytest.raises(AssertionError, match="bfloat16"):
        smoke.phase_gemm_kernels(torch, _gemm_stand_in(dropped), gref, CPU,
                                 cases=_gemm_cases(smoke))


def emulated_flash(q, k, v, *, causal, window, softcap, pad_to=None,
                   block=None, scale=None):
    """The kernel's arithmetic on [B, T, H, D], the scores scaled by
    ``scale`` (default 1/sqrt(D)); with ``pad_to``, K and V
    are padded with zero rows to a multiple of it and nothing masks them
    (the reference op's padding); with ``block``, each row sees every key
    in its ``block``-row block's key range (the loop bounds without the
    mask on the tiles that cross the diagonal or the window's edge)."""
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    if pad_to:
        pk = -Tk % pad_to
        k = torch.cat([k, k.new_zeros(B, pk, Hkv, D)], 1)
        v = torch.cat([v, v.new_zeros(B, pk, Hkv, v.shape[3])], 1)
    G = Hq // Hkv
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * (
        1.0 / math.sqrt(D) if scale is None else scale)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    seen = fref.attention_mask(Tq, k.shape[1], causal=causal, window=window)
    if block:
        first = torch.arange(Tq)[:, None] // block * block
        key = torch.arange(k.shape[1])[None, :]
        seen = torch.ones_like(seen)
        if causal:
            seen &= key < first + block
        if window is not None:
            seen &= key > first - window
    if not pad_to:
        seen &= torch.arange(k.shape[1])[None, :] < Tk
    s = torch.where(seen, s, -math.inf)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - torch.where(torch.isinf(m), 0.0, m))
    p = e.to(v.dtype).float()
    o = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    den = e.sum(-1).clamp_min(1e-30).transpose(1, 2)[..., None]
    return (o / den).to(q.dtype)


def _flash_path(q, *args):
    return "f32" if q.dtype == torch.float32 else "wgmma"


def _flash_stand_in(fn):
    ns = types.SimpleNamespace(
        LAUNCHES=0, PATH_LAUNCHES=dict.fromkeys(fops.PATH_LAUNCHES, 0),
        flash_attention_heads_ref=fops.flash_attention_heads_ref)
    ns.flash_attention_kernel = _counting_paths(ns, _flash_path, fn)
    ns.flash_attention = _counting_paths(ns, _flash_path,
                                         fops.flash_attention)
    return ns


def _flash_cases(smoke):
    a, b, c = smoke.FLASH_CASES[:3]
    return [dict(a, Tq=128, Tk=128), dict(b, Tq=384, Tk=384, window=128),
            dict(c, Tq=128, Tk=128, Hq=8, Hkv=8)] + smoke.FLASH_CASES[3:]


def test_flash_check_passes_the_emulated_kernel(smoke, no_sync, capsys):
    stand_in = _flash_stand_in(emulated_flash)
    err, rel = smoke.phase_flash_kernels(torch, stand_in, fref, CPU,
                                         cases=_flash_cases(smoke))
    out = capsys.readouterr().out
    print(out)
    assert 0 < err and 0 < rel <= smoke.BF16_ROW_RTOL_F32
    # one call per case, one more per B == 1 case (NaN past Tk), one for
    # the backward of (a)
    n_b1 = sum(c["B"] == 1 for c in smoke.FLASH_CASES)
    assert stand_in.LAUNCHES == len(smoke.FLASH_CASES) + n_b1 + 1
    assert "rows see no key" in out and "backward" in out


def test_flash_check_rejects_a_skipped_edge_mask(smoke, no_sync):
    stand_in = _flash_stand_in(
        lambda q, k, v, **kw: emulated_flash(q, k, v, block=128, **kw))
    with pytest.raises(AssertionError, match=r"\(a\) gemma2-2b global"):
        smoke.phase_flash_kernels(torch, stand_in, fref, CPU,
                                  cases=_flash_cases(smoke))


def test_flash_check_rejects_padded_keys(smoke, no_sync):
    stand_in = _flash_stand_in(
        lambda q, k, v, **kw: emulated_flash(q, k, v, pad_to=128, **kw))
    with pytest.raises(AssertionError, match=r"\(d\) non-causal"):
        smoke.phase_flash_kernels(torch, stand_in, fref, CPU,
                                  cases=_flash_cases(smoke))


def _strict(q, k, v, **kw):
    """``emulated_flash`` behind the checks ``flash_attention_kernel``
    makes: contiguous, on 16 bytes, bf16 D and Dv in multiples of 16."""
    for t in (q, k, v):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("not contiguous on 16 bytes")
    if q.dtype == torch.bfloat16 and (q.shape[3] % 16 or v.shape[3] % 16):
        raise ValueError("bf16 D and Dv must be multiples of 16")
    return emulated_flash(q, k, v, **kw)


def _padding_stand_in(kernel):
    ns = _flash_stand_in(kernel)
    ns.MAX_HEAD_DIM = fops.MAX_HEAD_DIM
    ns.flash_attention = lambda q, k, v, **kw: fops.kernel_forward(
        ns.flash_attention_kernel, q, k, v, **kw)
    return ns


def test_padding_check_passes_the_public_op_around_a_strict_kernel(
        smoke, no_sync, capsys):
    """ROADMAP C5: D 72 / Dv 40 and inputs off 16 bytes through the public
    op's pad-and-copy path, then D past 256 refused without a launch."""
    stand_in = _padding_stand_in(_strict)
    err, rel = smoke.phase_flash_padding(torch, stand_in, fref, CPU)
    out = capsys.readouterr().out
    print(out)
    assert stand_in.LAUNCHES == len(smoke.FLASH_PAD_CASES)
    assert 0 < err and 0 < rel <= smoke.BF16_ROW_RTOL_F32
    assert "(g) D 72, Dv 40" in out and "off 16 bytes" in out
    assert "raises ValueError" in out


def test_padding_check_rejects_the_padded_scale(smoke, no_sync):
    """A kernel that scales by 1/sqrt of the padded D (80, not 72) in
    bf16."""
    def padded_scale(q, k, v, **kw):
        kw["scale"] = None
        return _strict(q, k, v, **kw)

    with pytest.raises(AssertionError, match=r"\(g\) D 72"):
        smoke.phase_flash_padding(torch, _padding_stand_in(padded_scale),
                                  fref, CPU)


def _ops_path(smoke, monkeypatch, coded_tree_reduce=tops.coded_tree_reduce):
    """The ops path's stand-ins at small shapes: the ops themselves (their
    plain versions on the CPU) behind counters."""
    t = types.SimpleNamespace(TREE_SUM_LAUNCHES=0, INT8_TREE_SUM_LAUNCHES=0,
                              encode_rows=tops.encode_rows)
    t.tree_reduce = _counting(t, "TREE_SUM_LAUNCHES", tops.tree_reduce)
    coded = {c: _counting(t, "INT8_TREE_SUM_LAUNCHES" if c == "int8" else
                          "TREE_SUM_LAUNCHES", coded_tree_reduce)
             for c in ("bf16", "int8")}
    t.coded_tree_reduce = lambda wire, codec: coded[codec](wire, codec)
    g = _gemm_stand_in(gref.gemm_ref)
    g.gemm = g.gemm_kernel
    f = _flash_stand_in(emulated_flash)
    monkeypatch.setattr(smoke, "TREE_TIME_D", 4096)
    monkeypatch.setattr(smoke, "GEMM_CASES", [dict(smoke.GEMM_CASES[0],
                                                   M=64)])
    monkeypatch.setattr(smoke, "FLASH_CASES", [dict(smoke.FLASH_CASES[0],
                                                    Tq=128, Tk=128)])
    return t, g, f


def test_ops_path_counts_every_kernel(smoke, no_sync, monkeypatch, capsys):
    t, g, f = _ops_path(smoke, monkeypatch)
    counts, paths = smoke.phase_kernel_ops(torch, t, tref, g, f, CPU)
    assert counts == {"tree_reduce": 2, "int8_tree_reduce": 1, "gemm": 1,
                      "flash_attention": 1}
    assert paths == {"gemm": {"wgmma": 1, "mma": 0, "f32": 0},
                     "flash_attention": {"wgmma": 1, "f32": 0}}
    out = capsys.readouterr().out
    print(out)
    assert "bit-identical to ref.py" in out


def test_ops_path_rejects_an_int8_sum_that_skips_columns(smoke, no_sync,
                                                         monkeypatch):
    """A B4 whose grid-stride loop stops after its first sweep: the columns
    past it hold finite garbage, which only the bit-for-bit check sees."""
    def first_sweep_only(wire, codec):
        out = tops.coded_tree_reduce(wire, codec)
        if codec == "int8":
            out[1024:] = 0.5
        return out

    t, g, f = _ops_path(smoke, monkeypatch, first_sweep_only)
    with pytest.raises(AssertionError,
                       match="coded_tree_reduce int8 .* differs"):
        smoke.phase_kernel_ops(torch, t, tref, g, f, CPU)
