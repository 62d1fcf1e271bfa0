"""Error feedback in one pass (``kernels/codec``): the op that runs the
train step's ``bsp.ef`` phase.

On the CPU (tier-1):

  * the op's CPU path equals the step's four eager lines and
    ``optim/compression.error_feedback_step`` bit for bit, for int8 and
    bf16, with ragged bf16 lengths, the strided residual view (a column
    slice of ``[W, total]``), zero, -0, NaN, inf and subnormal blocks and
    exact ties;
  * the kernel's launch counters stay at 0 on the CPU, also through two
    BSP steps, which call the op once per codec'd bucket a step;
  * the op refuses what the kernel does not take (an int8 block other
    than 128, a codec with no kernel, CPU tensors at the kernel wrapper);
  * ``chip_smoke.py``'s check of the kernel passes the plain version in
    the kernel's place and rejects three faulty ones (int8's residual
    rounded twice, bf16 truncated, a row's short last chunk skipped); its
    check at the largest bucket's layout (a small copy of it) passes the
    plain version and rejects those two roundings and a write past the
    bucket's columns;
  * a host mirror of the kernel's launch (``ops.ef_plan``,
    ``ops.ef_chunks``, ``ops.lane_elements``) covers every element of
    ``[W, L]`` and of the residual's rows exactly once, within its row,
    with 16-byte vector accesses where the path is "vector": element by
    element at small and unaligned lengths, chunk by chunk at the
    benchmark's bucket lengths.

On the card (marked ``cuda``; they skip without one, and run with
``pytest -m cuda``): the kernel against the eager sequence on the card bit
for bit (NaN where it has NaN), on both paths; two BSP steps with the
kernel and with the eager sequence leave params, moments and residual bit
for bit equal; and the counters read one launch a codec'd bucket a step.
"""

import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.bsp import BSPConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels.codec import ops, ref
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_config
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.compression import (Bf16Codec, Codec, Int8Codec,
                                           error_feedback_step,
                                           quantization_error)
from repro_torch.runtime.trainer import make_bsp_train_step

CODECS = {"int8": Int8Codec(), "bf16": Bf16Codec()}
# the benchmark's buckets (qwen2.5-3b at 10 layers, --bucket-mb 256, world
# 4): (offset, length) into the residual's rows of TOTAL elements
BENCH_BUCKETS = [(0, 40960), (40960, 225443840), (225484800, 225443840),
                 (450928640, 225443840), (676372480, 47208960),
                 (723581440, 47190528), (770771968, 311164928)]
BENCH_TOTAL = 1081936896
ARCH = "qwen2.5-3b-smoke"
ROOT = Path(__file__).resolve().parents[1]


def _special_x(codec, W, L, rng):
    """[W, L] f32 values of x = g + res: gradient-like magnitudes, and in
    row 0 (int8: one block each, bf16: runs of 8) zeros, -0, a NaN, an
    inf, subnormals alone and under a normal, exact ties and the codes'
    edges; and the count of those special values."""
    x = (rng.standard_normal((W, L))
         * np.exp(2 * rng.standard_normal((W, L)))).astype(np.float32)
    n = 128 if codec == "int8" else 8
    ties = (np.arange(n) % 253 - 126 + 0.5).astype(np.float32)
    special = [
        np.zeros(n, np.float32),
        np.full(n, -0.0, np.float32),
        np.r_[np.float32(np.nan), x[0, 1:n]],
        np.r_[np.float32(np.inf), x[0, 1:n]],
        np.float32(3e-39) * np.linspace(-1, 1, n, dtype=np.float32),
        np.r_[np.float32(1e-30), np.full(n - 1, 1e-42, np.float32)],
        # 15.875 = 127 / 8: scale 0.125 exactly, so (k + .5) / 8 ties
        np.r_[np.float32(15.875), ties[1:] * np.float32(0.125)],
        # the codes' edges: ±127 x scale and just inside
        np.r_[np.float32(-15.875),
              np.tile(np.float32([15.875, -15.875, 15.8125, -15.8125]),
                      n // 4)[1:]],
    ]
    if codec == "bf16":
        # halfway between two bf16 values (even and odd below), the top of
        # f32 (rounds to inf in bf16)
        special += [np.float32([1 + 2 ** -8, 1 + 3 * 2 ** -8,
                                -(1 + 2 ** -8), 3.4028235e38,
                                -3.4028235e38, 2 ** -126, 1e-45, 1.0])]
    flat = np.concatenate(special)[: L]
    x[0, : flat.size] = flat
    return x, flat.size


def _bucket(codec, W, L, seed, rstride=None, res_off=0, g_off=0):
    """g [W, L] (contiguous, ``g_off`` elements into its storage) and res,
    columns ``res_off`` to ``res_off + L`` of a [W, rstride] state
    (default width ``res_off + L``), with g + res
    equal to ``_special_x`` exactly (res -0.0 in the special run, so x + res
    is x)."""
    rng = np.random.default_rng(seed)
    x, n_special = _special_x(codec, W, L, rng)
    r = (rng.standard_normal((W, L)) * 1e-3).astype(np.float32)
    r[0, :n_special] = -0.0
    g = (x - r).astype(np.float32)
    keep = np.isfinite(x) & (r != 0)
    g[~keep] = x[~keep]
    r[~keep] = -0.0
    rstride = res_off + L if rstride is None else rstride
    state = torch.zeros(W, rstride)
    res = state[:, res_off:res_off + L]
    res.copy_(torch.from_numpy(r))
    store = torch.zeros(W * L + g_off)
    gt = store[g_off:].view(W, L)
    gt.copy_(torch.from_numpy(g))
    return gt, res


def _four_lines(g, res, codec):
    """The train step's EF before the kernel, as it stood."""
    g.add_(res)
    new_res = quantization_error(g, codec)
    res.copy_(new_res)
    g.sub_(new_res)
    del new_res


def _bits(t):
    return t.contiguous().view(torch.int32)


def _same(a, b):
    """Bit for bit, except that any NaN equals any NaN."""
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    return torch.equal(nan_a, nan_b) and torch.equal(
        _bits(torch.where(nan_a, torch.zeros_like(a), a)),
        _bits(torch.where(nan_b, torch.zeros_like(b), b)))


# --------------------------------------------------------------------------
# the CPU path
# --------------------------------------------------------------------------

CPU_CASES = [("int8", 1, 1024, None), ("int8", 4, 1280, 1280 + 384),
             ("int8", 3, 128 * 9, 128 * 11),
             ("bf16", 4, 1000, 1152), ("bf16", 2, 1001, 1131),
             ("bf16", 3, 130, 259), ("bf16", 1, 77, None),
             ("bf16", 4, 3, 135)]


@pytest.mark.parametrize("codec,W,L,rstride", CPU_CASES)
def test_cpu_path_equals_four_lines_and_error_feedback_step(codec, W, L,
                                                            rstride):
    c = CODECS[codec]
    g, res = _bucket(codec, W, L, seed=W * L, rstride=rstride, res_off=128)
    g0, res0 = g.clone(), res.clone()
    state = res._base if res._base is not None else res
    state0 = state.clone()
    ops.error_feedback_(g, res, c)
    g4, res4 = g0.clone(), res0.clone()
    _four_lines(g4, res4, c)
    assert torch.equal(_bits(g), _bits(g4))
    assert torch.equal(_bits(res), _bits(res4))
    corrected, new_res = error_feedback_step(g0, res0, c)
    assert torch.equal(_bits(res), _bits(new_res))
    assert torch.equal(_bits(g), _bits(corrected - new_res))
    # the slice's neighbours in the residual's rows are untouched
    outside = torch.ones_like(state, dtype=torch.bool)
    outside[:, 128:128 + L] = False
    assert torch.equal(state[outside], state0[outside])
    assert ops.EF_LAUNCHES == {"int8": 0, "bf16": 0}
    assert ops.EF_LAUNCHES_BY_PATH == {"vector": 0, "scalar": 0}


def test_zero_blocks_stay_zero_and_ties_round_to_even():
    """x = 0 (or -0) leaves residual 0 and sends 0; the ties of the
    15.875 block (scale 1/8) round to the even code, so the residual is
    ±scale/2 at each and alternates in sign."""
    g, res = _bucket("int8", 1, 128 * 8, seed=5)
    ops.error_feedback_(g, res, CODECS["int8"])
    assert torch.equal(_bits(res[0, :128]),
                       torch.zeros(128, dtype=torch.int32))
    assert torch.equal(g[0, :256], torch.zeros(256))
    tie_r = res[0, 6 * 128 + 1:7 * 128]
    assert torch.all(tie_r.abs() == 0.0625)
    assert torch.all(tie_r[1:] * tie_r[:-1] < 0)
    codes = (g[0, 6 * 128 + 1:7 * 128] / 0.125)
    assert torch.all(codes.remainder(2) == 0)


def test_op_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="blocks of 128"):
        ops.codec_name(Int8Codec(block=64))
    with pytest.raises(TypeError, match="no EF kernel"):
        ops.codec_name(Codec())
    g, res = _bucket("bf16", 2, 8, seed=1)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.error_feedback_kernel(g, res, CODECS["bf16"])
    assert ops.EF_LAUNCHES == {"int8": 0, "bf16": 0}


def _qwen_step(codec, device, bucket_mb=0.25):
    cfg = get_config(ARCH)
    step, init_state = make_bsp_train_step(
        cfg, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=100),
        BSPConfig(bucket_mb=bucket_mb, bucket_codec=codec), 4,
        device=device)
    state = init_state(T.init_params(cfg, seed=0, device=device))
    data = SyntheticLM(cfg, DataConfig(global_batch=8, seq_len=16, seed=3))
    return step, init_state, state, data


def test_step_calls_ef_once_a_codec_bucket_and_launches_nothing_on_cpu(
        monkeypatch):
    step, init_state, state, data = _qwen_step("int8", "cpu")
    calls = []
    plain = ops.error_feedback_

    def counted(g, res, codec):
        calls.append((tuple(g.shape), res.stride(0)))
        plain(g, res, codec)

    monkeypatch.setattr(ops, "error_feedback_", counted)
    for s in range(2):
        state, metrics = step(state, data.batch(s))
        assert torch.isfinite(metrics["loss"])
    engine = init_state.engine
    lens = [(4, b.length) for b, c in zip(engine.buckets,
                                          engine.bucket_codecs)
            if c is not None]
    assert len(lens) == engine.n_buckets > 1
    assert [s for s, _ in calls] == lens * 2
    assert {st for _, st in calls} == {engine.total_padded}
    assert ops.EF_LAUNCHES == {"int8": 0, "bf16": 0}
    assert ops.EF_LAUNCHES_BY_PATH == {"vector": 0, "scalar": 0}


# --------------------------------------------------------------------------
# the host mirror of the launch
# --------------------------------------------------------------------------

def _covered(plan, path, rstride):
    """Counts of each g element and each residual storage element the
    mirrored launch touches, lane by lane, with the vector path's 16-byte
    alignment checked."""
    W, L = plan["W"], plan["L"]
    ch = ops.ef_chunks(plan, np.arange(plan["chunks"]), rstride)
    assert np.all((ch["warp"] >= 0) & (ch["warp"] < plan["warps"]))
    # warp w takes chunks w, w + warps, ...: its iterations in order
    assert np.array_equal(ch["step"] * plan["warps"] + ch["warp"],
                          np.arange(plan["chunks"]))
    g_hits = np.zeros(W * L, np.int64)
    r_hits = np.zeros(max(0, (W - 1) * rstride + L), np.int64)
    for cols in np.unique(ch["cols"]):
        sel = ch["cols"] == cols
        for lane, elems in enumerate(ops.lane_elements(path, int(cols))):
            if path == "vector" and elems:
                assert elems == list(range(4 * lane, 4 * lane + 4))
                assert np.all((ch["g_off"][sel] + elems[0]) % 4 == 0)
                assert np.all((ch["r_off"][sel] + elems[0]) % 4 == 0)
            for e in elems:
                assert np.all(ch["col"][sel] + e < L)     # within its row
                np.add.at(g_hits, ch["g_off"][sel] + e, 1)
                np.add.at(r_hits, ch["r_off"][sel] + e, 1)
    return g_hits, r_hits


PLAN_CASES = [(1, 1), (1, 3), (4, 4), (2, 127), (3, 128), (4, 129),
              (4, 130), (2, 1000), (3, 1001), (4, 128 * 17),
              (4, 128 * 2200 + 4), (4, 128 * 2200)]


@pytest.mark.parametrize("W,L", PLAN_CASES)
def test_plan_covers_every_element_once(W, L):
    for path in ("vector", "scalar"):
        if path == "vector" and L % 4:
            continue
        for rstride in ({L, L + 4, L + 128} if path == "vector"
                        else {L, L + 1, L + 3}):
            plan = ops.ef_plan(W, L)
            assert 1 <= plan["grid"] <= ops.MAX_BLOCKS
            assert plan["warps"] == plan["grid"] * ops.WARPS_PER_BLOCK
            g_hits, r_hits = _covered(plan, path, rstride)
            assert np.all(g_hits == 1)
            rows = np.zeros_like(r_hits)
            for r in range(W):
                rows[r * rstride:r * rstride + L] = 1
            assert np.array_equal(r_hits, rows)


def test_plan_wraps_the_grid_at_large_counts():
    """More chunks than warps: the persistent grid is full and its warps
    take several chunks each."""
    plan = ops.ef_plan(4, 128 * 2200)
    assert plan["grid"] == ops.MAX_BLOCKS
    assert plan["chunks"] > 1.04 * plan["warps"]


@pytest.mark.parametrize("off,L", BENCH_BUCKETS)
def test_plan_at_the_benchmark_buckets(off, L):
    """Chunk by chunk over each row of every bucket of the benchmark's
    plan: the chunks tile the row in order and land on its columns of the
    residual; all full (L % 128 == 0), so int8 runs on every one; the
    offsets on 16 bytes, so the bucket takes the vector path."""
    W = 4
    assert L % 128 == 0 and off % 4 == 0 and BENCH_TOTAL % 4 == 0
    plan = ops.ef_plan(W, L)
    cpr = plan["chunks_per_row"]
    assert cpr == L // 128 and plan["chunks"] == W * cpr
    assert plan["grid"] == min(-(-W * cpr // 8), ops.MAX_BLOCKS)
    seen = 0
    for row in range(W):
        ch = ops.ef_chunks(plan, np.arange(row * cpr, (row + 1) * cpr,
                                           dtype=np.int64), BENCH_TOTAL)
        assert np.all(ch["row"] == row) and np.all(ch["cols"] == 128)
        assert ch["g_off"][0] == row * L
        assert np.all(np.diff(ch["g_off"]) == 128)
        assert np.all(ch["r_off"] - ch["g_off"]
                      == row * (BENCH_TOTAL - L))
        assert np.all((ch["r_off"] + off) % 4 == 0)
        seen += int(ch["cols"].sum())
        del ch
    assert seen == W * L


def test_path_follows_alignment_and_strides():
    base = torch.zeros(4 * 1030 + 8)
    g = base[:4 * 1024].view(4, 1024)
    state = torch.zeros(4, 2048 + 8)
    assert ops.ef_path(g, state[:, 128:128 + 1024]) == "vector"
    assert ops.ef_path(g, state[:, 129:129 + 1024]) == "scalar"
    assert ops.ef_path(base[1:1 + 4096].view(4, 1024),
                       state[:, 128:128 + 1024]) == "scalar"
    odd = torch.zeros(4, 2047)
    assert ops.ef_path(g, odd[:, 0:1024]) == "scalar"
    g_r = base[:4 * 1030].view(4, 1030)
    assert ops.ef_path(g_r, state[:, 0:1030]) == "scalar"


# --------------------------------------------------------------------------
# chip_smoke.py's check of the kernel, rehearsed with stand-ins
# --------------------------------------------------------------------------

@pytest.fixture
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_ef", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stand_in(body):
    """A module like ``ops`` whose kernel runs ``body`` on the CPU and
    counts its launches by path as the kernel wrapper does."""
    paths = {"vector": 0, "scalar": 0}

    def kernel(g, res, codec):
        body(g, res, codec)
        paths[ops.ef_path(g, res)] += 1

    return types.SimpleNamespace(error_feedback_kernel=kernel,
                                 ef_path=ops.ef_path,
                                 EF_LAUNCHES_BY_PATH=paths)


def _unfused_int8(g, res, codec):
    """int8's residual from a rounded product, then the difference."""
    if not isinstance(codec, Int8Codec):
        return ref.error_feedback_ref_(g, res, codec)
    x = g + res
    wire = codec.encode(x)
    prod = wire["q"].float() * wire["scale"]
    new = x - prod.reshape(x.shape)
    res.copy_(new)
    g.copy_(x - new)


def _truncating_bf16(g, res, codec):
    """bf16 by dropping the low half of the bits, not rounding."""
    if not isinstance(codec, Bf16Codec):
        return ref.error_feedback_ref_(g, res, codec)
    x = g + res
    d = (x.view(torch.int32) & -65536).view(torch.float32)
    res.copy_(x - d)
    g.copy_(d)


def _short_last_chunk(g, res, codec):
    """A row's last chunk, where shorter than 128, left untouched."""
    L = g.shape[1]
    keep = L - L % 128 if L % 128 else L
    ref.error_feedback_ref_(g[:, :keep], res[:, :keep], codec)


def test_smoke_ef_check_passes_the_plain_version(smoke, capsys):
    made = smoke.phase_ef_kernels(torch, _stand_in(ref.error_feedback_ref_),
                                  ref, CODECS, torch.device("cpu"))
    assert made == {"vector": 4, "scalar": 4}
    assert capsys.readouterr().out.count("bit-identical") == \
        len(smoke.EF_CASES)


@pytest.mark.parametrize("fault", [_unfused_int8, _truncating_bf16,
                                   _short_last_chunk])
def test_smoke_ef_check_rejects_a_faulty_kernel(smoke, fault):
    with pytest.raises(AssertionError, match="differs from the eager"):
        smoke.phase_ef_kernels(torch, _stand_in(fault), ref, CODECS,
                               torch.device("cpu"))


# the int8 cell's largest bucket in small: 16 blocks a row in columns
# 640.. of a [4, 5120] state
SMALL_BUCKET = dict(W=4, L=128 * 16, total=128 * 40, off=128 * 5)


def _spills_past_the_bucket(g, res, codec):
    """EF right, then the element after row 0's last column written."""
    ref.error_feedback_ref_(g, res, codec)
    res.as_strided((1,), (1,), res.storage_offset() + res.shape[1]).fill_(1.)


def test_smoke_ef_bucket_check_passes_the_plain_version(smoke, capsys):
    out = smoke.phase_ef_bucket(torch, _stand_in(ref.error_feedback_ref_),
                                ref, CODECS, torch.device("cpu"),
                                **SMALL_BUCKET)
    assert out["elements"] == 2 * 4 * 2048
    assert out["max_res_offset"] == 3 * 5120 + 640 + 2048 - 1
    text = capsys.readouterr().out
    assert text.count("bit-identical") == 2
    assert text.count("untouched") == 2


@pytest.mark.parametrize("fault, says", [
    (_unfused_int8, "differ from the eager"),
    (_truncating_bf16, "differ from the eager"),
    (_spills_past_the_bucket, r"\[1, 0, 0, 0\] elements written outside")])
def test_smoke_ef_bucket_check_rejects_a_faulty_kernel(smoke, fault, says):
    with pytest.raises(AssertionError, match=says):
        smoke.phase_ef_bucket(torch, _stand_in(fault), ref, CODECS,
                              torch.device("cpu"), **SMALL_BUCKET)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card via "
                    "pytest -m cuda)")


# (codec, W, L, the residual's row stride, its column offset, g's offset
# in its storage, the path the case must take); the second case of each
# codec has more chunks than the grid has warps
CARD_CASES = [
    ("int8", 4, 128 * 40, 128 * 42, 128, 0, "vector"),
    ("int8", 4, 128 * 3001, 128 * 3004, 256, 0, "vector"),
    ("int8", 2, 128 * 12, 128 * 12 + 3, 0, 0, "scalar"),
    ("int8", 3, 128 * 12, 128 * 13, 128, 1, "scalar"),
    ("bf16", 4, 1000, 1152, 128, 0, "vector"),
    ("bf16", 4, 128 * 3001 + 4, 128 * 3004, 4, 0, "vector"),
    ("bf16", 2, 1001, 1003, 1, 0, "scalar"),
    ("bf16", 3, 130, 131, 0, 2, "scalar"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("codec,W,L,rstride,res_off,g_off,path", CARD_CASES)
def test_kernel_equals_the_eager_sequence_on_the_card(codec, W, L, rstride,
                                                      res_off, g_off, path):
    _need_cuda()
    dev = torch.device("cuda")
    c = CODECS[codec]
    g_c, res_c = _bucket(codec, W, L, seed=L, rstride=rstride,
                         res_off=res_off, g_off=g_off)
    outs = {}
    for label in ("kernel", "eager"):
        store = torch.zeros(W * L + g_off, device=dev)
        g = store[g_off:].view(W, L)
        g.copy_(g_c)
        state = torch.zeros(W, rstride, device=dev)
        res = state[:, res_off:res_off + L]
        res.copy_(res_c)
        if label == "kernel":
            assert ops.ef_path(g, res) == path
            before = dict(ops.EF_LAUNCHES_BY_PATH)
            ops.error_feedback_(g, res, c)
            assert ops.EF_LAUNCHES_BY_PATH[path] == before[path] + 1
        else:
            ref.error_feedback_ref_(g, res, c)
        torch.cuda.synchronize()
        outs[label] = (g.cpu(), state.cpu())
    assert _same(outs["kernel"][0], outs["eager"][0]), "g' differs"
    assert _same(outs["kernel"][1], outs["eager"][1]), "residual differs"


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["int8", "bf16"])
def test_two_steps_bit_for_bit_with_the_kernel_and_the_eager_sequence(
        codec, monkeypatch):
    """Two BSP steps of a small qwen2.5-3b at world 4: params, both
    moments and the EF residual bit for bit the same whether EF runs the
    kernel or the eager sequence; the kernel once a codec'd bucket a
    step, on the vector path, and nothing else on the device during EF
    (each call profiled)."""
    _need_cuda()
    finals, device_ops = {}, []
    kernel_op = ops.error_feedback_

    def profiled(g, res, codec):
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            kernel_op(g, res, codec)
            torch.cuda.synchronize()
        device_ops.append([e.name for e in prof.events()
                           if e.device_type == torch.autograd.DeviceType.CUDA])

    for label in ("kernel", "eager"):
        with monkeypatch.context() as m:
            m.setattr(ops, "error_feedback_", profiled if label == "kernel"
                      else ref.error_feedback_ref_)
            step, init_state, state, data = _qwen_step(codec, "cuda")
            before = (dict(ops.EF_LAUNCHES), dict(ops.EF_LAUNCHES_BY_PATH))
            for s in range(2):
                state, _ = step(state, data.batch(s))
            torch.cuda.synchronize()
        n = init_state.engine.n_buckets
        want = 2 * n if label == "kernel" else 0
        assert ops.EF_LAUNCHES[codec] - before[0][codec] == want
        assert ops.EF_LAUNCHES_BY_PATH["vector"] - before[1]["vector"] \
            == want
        assert ops.EF_LAUNCHES_BY_PATH["scalar"] == before[1]["scalar"]
        finals[label] = ({k: v.detach().cpu() for k, v in
                          _flat_params(state.params).items()},
                         state.flat_mu.cpu(), state.flat_nu.cpu(),
                         state.ef_residual.cpu())
        del state, step, init_state
    assert len(device_ops) == 2 * n
    for names in device_ops:
        assert len(names) == 1 and "error_feedback_kernel" in names[0], names
    (pk, mk, nk, ek), (pe, me, ne, ee) = finals["kernel"], finals["eager"]
    assert pk.keys() == pe.keys()
    for k in pk:
        assert _same(pk[k].float(), pe[k].float()), k
    assert _same(mk, me) and _same(nk, ne) and _same(ek, ee)


def _flat_params(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat_params(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat_params(v, f"{prefix}{i}/"))
    elif isinstance(tree, torch.Tensor):
        out[prefix[:-1]] = tree
    return out
