"""``chip_smoke.py``'s checks of B3-B6 and the public kernel ops, run on the
CPU against stand-ins.

The CUDA kernels cannot run here, so stand-ins take their places and count
their calls as the kernel wrappers count launches:

  * B3/B4: the plain versions themselves (``phase_tree_kernels`` must find
    them bit-identical), and a sum in linear order, which it must reject;
    an emulation of the ring kernel on a stand-in card of 3 SMs
    (``ops.tree_sum_tiles``' walk, each item's rows halved through
    ref.py's arithmetic, B4's codes widened by the kernel's exponent
    trick, the later passes in place over the f32 scratch; the plain
    versions on the ragged path), which must pass bit for bit with every
    case on its path, and three faulty ones it must reject: a walk that
    drops the short last tile of a row, one that covers a tile twice
    (harmless except in place, at N = 100) and one that widens int8
    codes through a rounding conversion (the same trick at 2^24);
  * the B3/B4 guard-byte run (``_tree_guarded_run``) around the ring
    emulation: clean passes; a write past the output, an output element
    left unwritten and a changed input are caught;
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
    (and by path) must come out as the phase asserts, an int8 sum that
    leaves finite garbage past its first sweep must fail the bit-for-bit
    check, and sums that took the ragged kernel must fail the path check.

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


# the stand-in card of the ring emulation: 3 SMs, one ring block each
RING_GRID = (3, 1)


def _into_buffers(ns, N, want):
    """``want`` written into the buffers ``ns._buffers`` hands out, as a
    wrapper returns its output (the scratch written too)."""
    out, scratch = ns._buffers(N, want.numel(), want.dtype, want.device)
    if scratch is not None:
        scratch.zero_()
    return out.copy_(want)


def _plain_b3(ns, x, od=None):
    return _into_buffers(ns, x.shape[0],
                         tref.tree_reduce_ref(tref.pad_rows(x), od))


def _plain_b4(ns, q, s):
    return _into_buffers(ns, q.shape[0], tref.int8_tree_reduce_ref(
        tref.pad_rows(q), tref.pad_rows(s)))


def ring_codes(q):
    """int8 codes widened as the ring kernel widens them: the biased byte
    q + 128 as the low mantissa byte of 2^23, minus 2^23 + 128 (exact)."""
    biased = (q.to(torch.int32) & 0xFF) ^ 0x80
    return (biased | 0x4B000000).view(torch.float32) - \
        torch.tensor(8388736.0)


def rounding_codes(q):
    """The same trick at 2^24, where the float spacing is 2: odd biased
    bytes round to even."""
    biased = ((q.to(torch.int32) & 0xFF) ^ 0x80).float()
    return (torch.tensor(2.0 ** 24) + biased) - (2.0 ** 24 + 128)


def emulated_ring(ns, x, od=None, scale=None, *, codes=ring_codes,
                  fault=None):
    """B3 (x [N, D] f32/bf16 into ``od``) or B4 (x = q [N, nb, 128] with
    ``scale``) as the ring kernel computes it on the stand-in card:
    ``ops.tree_sum_tiles``' walk pass by pass, each block's items in
    order, each item's real rows (absent ones +0) halved with ref.py's
    arithmetic (B4's first level ref.py's fused product, on codes widened
    by ``codes``) into its output tile; passes after the first read the
    f32 scratch and write it in place.  Buffers come from ``ns._buffers``,
    as the wrapper takes them.  ``fault``: "drop_last" skips the short
    last tile of a row (its memory holds NaN), "twice" runs each block's
    first item again after its last."""
    int8 = scale is not None
    N = x.shape[0]
    D = x[0].numel()
    od = od or (torch.float32 if int8 else x.dtype)
    out, scratch = ns._buffers(N, D, od, x.device)
    if fault == "drop_last":
        out.fill_(float("nan"))
    src = x.reshape(N, D)
    if int8:
        scales = scale.reshape(N, -1).repeat_interleave(tref.CODEC_BLOCK, 1)
    passes = tops.tree_sum_tiles(N, D, x.element_size(), *RING_GRID)
    for i, p in enumerate(passes):
        dst = out.view(1, D) if i == len(passes) - 1 else scratch
        rows_n, T = 1 << p["levels"], p["tile_cols"]
        for walk in p["blocks"]:
            for it in walk + (walk[:1] if fault == "twice" else []):
                if fault == "drop_last" and it["cols"] < T:
                    continue
                c = slice(it["c0"], it["c0"] + it["cols"])
                rows = [r for r, _, _ in it["copies"]]
                acc = torch.zeros(rows_n, it["cols"])
                if int8 and i == 0:
                    sc = torch.zeros(rows_n, it["cols"])
                    acc[:len(rows)] = codes(src[rows, c])
                    sc[:len(rows)] = scales[rows, c]
                    h = rows_n // 2
                    acc = torch.addcmul(acc[h:] * sc[h:], acc[:h], sc[:h])
                else:
                    acc[:len(rows)] = src[rows, c].float()
                dst[it["o"], c] = tref._halve(acc).to(dst.dtype)
        src = scratch
    return out


def _tree_stand_in(tree_sum=None, ring=None, **ring_kw):
    """Counting stand-ins of the B3/B4 wrappers: ``tree_sum`` (default the
    plain version) for B3 on any path, or with ``ring`` the ring emulation
    (keywords ``ring_kw``) on the ring path and the plain versions on the
    ragged one; counts by ``ops.tree_sum_path``."""
    ns = types.SimpleNamespace(
        TREE_SUM_LAUNCHES=0, INT8_TREE_SUM_LAUNCHES=0,
        TREE_SUM_LAUNCHES_BY_PATH={"ring": 0, "ragged": 0},
        INT8_TREE_SUM_LAUNCHES_BY_PATH={"ring": 0, "ragged": 0},
        encode_rows=tops.encode_rows, ring_stages=tops.ring_stages,
        RING_SLICE_BYTES=tops.RING_SLICE_BYTES, _buffers=tops._buffers,
        ring_occupancy=lambda *a: RING_GRID)

    def b3(x, od=None):
        path = tops.tree_sum_path(x)
        ns.TREE_SUM_LAUNCHES += 1
        ns.TREE_SUM_LAUNCHES_BY_PATH[path] += 1
        if tree_sum is not None:
            return tree_sum(x, od)
        if ring and path == "ring":
            return emulated_ring(ns, x, od, **ring_kw)
        return _plain_b3(ns, x, od)

    def b4(q, s):
        path = tops.tree_sum_path(q, s)
        ns.INT8_TREE_SUM_LAUNCHES += 1
        ns.INT8_TREE_SUM_LAUNCHES_BY_PATH[path] += 1
        if ring and path == "ring":
            return emulated_ring(ns, q, None, s, **ring_kw)
        return _plain_b4(ns, q, s)

    ns.tree_reduce_kernel, ns.int8_tree_reduce_kernel = b3, b4
    return ns


def _linear_order(x, od=None):
    acc = x[0].float()
    for i in range(1, x.shape[0]):
        acc = acc + x[i].float()
    return acc.to(od or x.dtype)


def _tree_counts(smoke):
    """(B3 calls, B4 calls, "bit-identical" lines) of phase_tree_kernels:
    each N of TREE_NS at every width, f32 and bf16 rows into both; at
    each N of TREE_WRAP_NS the wrap width and a view off 16 bytes in both
    dtypes (B3) and the wrap width and two views (B4)."""
    n, w = len(smoke.TREE_NS), len(smoke.TREE_WRAP_NS)
    b3 = n * len(smoke.TREE_DS + smoke.TREE_TILE_DS) * 4 + w * 2 * 2 * 2
    b4 = n * len(smoke.INT8_TREE_NBS + smoke.INT8_TILE_NBS) + w * 3
    lines = n * (len(smoke.TREE_DS + smoke.TREE_TILE_DS) + 1) + w
    return b3, b4, lines


def test_tree_check_passes_the_plain_versions(smoke, no_sync, capsys):
    stand_in = _tree_stand_in()
    worst = smoke.phase_tree_kernels(torch, stand_in, tref, CPU)
    assert worst == {"tree_reduce": 0.0, "int8_tree_reduce": 0.0}
    b3, b4, lines = _tree_counts(smoke)
    assert stand_in.TREE_SUM_LAUNCHES == b3
    assert stand_in.INT8_TREE_SUM_LAUNCHES == b4
    assert capsys.readouterr().out.count("bit-identical") == lines


def test_tree_check_rejects_a_linear_order_sum(smoke, no_sync):
    with pytest.raises(AssertionError, match="B3 N=.* differs"):
        smoke.phase_tree_kernels(torch, _tree_stand_in(_linear_order), tref,
                                 CPU)


def test_tree_check_passes_the_emulated_ring(smoke, no_sync, capsys):
    """Every case bit for bit through the ring's walk, each on its path:
    the ring takes the aligned widths and the ragged kernel the rest."""
    stand_in = _tree_stand_in(ring=True)
    worst = smoke.phase_tree_kernels(torch, stand_in, tref, CPU)
    assert worst == {"tree_reduce": 0.0, "int8_tree_reduce": 0.0}
    b3, b4, lines = _tree_counts(smoke)
    assert sum(stand_in.TREE_SUM_LAUNCHES_BY_PATH.values()) == b3
    assert sum(stand_in.INT8_TREE_SUM_LAUNCHES_BY_PATH.values()) == b4
    assert min(stand_in.TREE_SUM_LAUNCHES_BY_PATH.values()) > 0
    assert min(stand_in.INT8_TREE_SUM_LAUNCHES_BY_PATH.values()) > 0
    out = capsys.readouterr().out
    print(out)
    assert out.count("bit-identical") == lines


@pytest.mark.parametrize("fault,match", [
    ("drop_last", r"B3 N=1 D=700 float32 -> float32 differs"),
    ("twice", r"B3 N=100 D=700 float32 -> float32 differs"),
    ("rounding", r"B4 N=1 nb=1100 differs")])
def test_tree_check_rejects_a_faulty_ring(smoke, no_sync, fault, match):
    """A walk that drops the short last tile of a row (caught at the first
    ring case), one that covers a tile twice (caught where a pass runs in
    place, N = 100) and one whose int8 codes go through a rounding
    conversion (caught at B4's first ring case)."""
    kw = ({"codes": rounding_codes} if fault == "rounding" else
          {"fault": fault})
    with pytest.raises(AssertionError, match=match):
        smoke.phase_tree_kernels(torch, _tree_stand_in(ring=True, **kw),
                                 tref, CPU)


def _guard_fault(ns, fault):
    """The B3/B4 ring emulation with one fault for the guard-byte run:
    a write one element past its output, its output's last element left
    as the buffer held it, or its input changed in place."""
    def b3(x):
        real = ns._buffers

        def buffers(*a):
            out, scratch = real(*a)
            if fault == "unset":       # keep the last element as it was
                keep = out[-1:].clone()
                ns._restore = lambda: out[-1:].copy_(keep)
            ns._out = out
            return out, scratch

        ns._buffers = buffers
        try:
            got = emulated_ring(ns, x)
        finally:
            ns._buffers = real
        if fault == "unset":
            ns._restore()
        if fault == "past_out" and ns._out.storage_offset():
            ns._out.view(-1).as_strided((ns._out.numel() + 1,), (1,))[-1] = 0
        if fault == "input":
            x.view(-1)[0] += 1
        return got
    return b3


@pytest.mark.parametrize("fault", [None, "past_out", "unset", "input"])
def test_tree_guarded_run_catches_stray_writes(smoke, no_sync, fault):
    """chip_smoke's guard-byte check of B3/B4 around the ring emulation at
    N = 13 (a pass into scratch and one out of it) and N = 100 (a pass in
    place): clean passes; the faults are caught."""
    g = torch.Generator()
    g.manual_seed(0)
    ns = _tree_stand_in(ring=True)
    for N in (13, 100):
        x = smoke._tree_rows(torch, N, 2056, g, CPU)
        kernel = _guard_fault(ns, fault)
        if fault is None:
            assert smoke._tree_guarded_run(torch, ns, kernel, (x,),
                                           "clean") == 1
            q, sc = smoke._int8_wire(torch, tops, N, 68, g, CPU)
            smoke._tree_guarded_run(
                torch, ns, lambda q, s: emulated_ring(ns, q, None, s),
                (q, sc), "clean B4")
            continue
        want = {"past_out": "a write past the output",
                "unset": "an element of the output not written",
                "input": "input 0"}[fault]
        with pytest.raises(AssertionError, match=want):
            smoke._tree_guarded_run(torch, ns, kernel, (x,), fault)


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
    t = _tree_stand_in()

    def counted(int8, fn):
        def wrapped(*args):
            path = (tops.tree_sum_path(args[0]["q"], args[0]["scale"])
                    if int8 else tops.tree_sum_path(
                        args[0]["x"] if isinstance(args[0], dict)
                        else args[0]))
            name = "INT8_TREE_SUM_LAUNCHES" if int8 else "TREE_SUM_LAUNCHES"
            setattr(t, name, getattr(t, name) + 1)
            getattr(t, f"{name}_BY_PATH")[path] += 1
            return fn(*args)
        return wrapped

    t.tree_reduce = counted(False, tops.tree_reduce)
    coded = {c: counted(c == "int8", coded_tree_reduce)
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
                     "flash_attention": {"wgmma": 1, "f32": 0},
                     "tree_reduce": {"ring": 2, "ragged": 0},
                     "int8_tree_reduce": {"ring": 1, "ragged": 0}}
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


def test_ops_path_rejects_sums_off_the_ring(smoke, no_sync, monkeypatch):
    """The ops path's sums at the timed shape must launch the ring
    kernels: a wrapper that took the ragged kernel is rejected."""
    t, g, f = _ops_path(smoke, monkeypatch)
    monkeypatch.setattr(tops, "tree_sum_path", lambda *a: "ragged")
    with pytest.raises(AssertionError,
                       match="tree_reduce on the ops path launched"):
        smoke.phase_kernel_ops(torch, t, tref, g, f, CPU)


def test_tree_guard_phase_passes_the_emulated_ring(smoke, no_sync):
    """``phase_tree_guards`` end to end on the CPU: every case through the
    guard-byte run, the ring emulation on its path and the plain versions
    (written into the wrapper's buffers) on the ragged one."""
    ns = _tree_stand_in(ring=True)
    calls = smoke.phase_tree_guards(torch, ns, CPU)
    assert calls == ns.TREE_SUM_LAUNCHES + ns.INT8_TREE_SUM_LAUNCHES == 96
    assert ns.TREE_SUM_LAUNCHES_BY_PATH == {"ring": 36, "ragged": 36}
    assert ns.INT8_TREE_SUM_LAUNCHES_BY_PATH == {"ring": 12, "ragged": 12}
