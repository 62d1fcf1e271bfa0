"""Port parity: the rank-stacked FractalSync collectives and wire codecs.

The reference runs its collectives in one process under
``jax.jit(jax.vmap(fn, axis_name="data"))`` on a ``[W, M]`` array — the
port's own rank-stacked layout — so every rank's result is compared with
``==``: codes, scales, EF residuals, reduce-scatter shards (each hop's
decode-add included), all-gathers, all-reduces, barrier tokens and the
bit-reversed shard order, for codecs none/bf16/int8 at worlds 4 and 8.
Under ``jit`` XLA divides by 127 as a multiply by f32(1/127) and contracts
the int8 dequant-add and residual into fused multiply-adds; the port spells
both out, so the results are equal, not close.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import collectives as JC
from repro.optim import compression as JZ
from repro_torch.core import collectives as C
from repro_torch.core.bsp import BSPConfig, make_codec, resolve_schedule
from repro_torch.optim import compression as Z

CODECS = ["none", "bf16", "int8"]
WORLDS = [4, 8]


def _jcodec(name):
    return {"none": None, "bf16": JZ.Bf16Codec(),
            "int8": JZ.Int8Codec()}[name]


def _payload(W, M, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((W, M)) * np.exp(rng.standard_normal((W, M)))
    return x.astype(np.float32)


def _vmap(fn, *arrays):
    out = jax.jit(jax.vmap(fn, axis_name="data"))(
        *[jnp.asarray(a) for a in arrays])
    return jax.tree.map(np.asarray, out)


def _bits_equal(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), \
        f"max diff {np.abs(got - want).max()}"


@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_codec_rows_match_jitted_reference(codec):
    """Encode, decode, quantization error and the EF step of every rank's
    row equal the reference's per-rank (jitted) results."""
    W, M = 4, 1024
    x, res = _payload(W, M, 1), 1e-3 * _payload(W, M, 2)
    jc, c = _jcodec(codec), make_codec(codec)
    want = _vmap(lambda v: jc.encode(v), x)
    got = c.encode(torch.from_numpy(x))
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k].float().numpy(),
                              np.asarray(want[k], np.float32))
    jq = _vmap(lambda v: JZ.quantization_error(v, jc), x)
    _bits_equal(Z.quantization_error(torch.from_numpy(x), c), jq)
    jcorr, jres = _vmap(lambda g, r: JZ.error_feedback_step(g, r, jc), x, res)
    corr, new_res = Z.error_feedback_step(torch.from_numpy(x),
                                          torch.from_numpy(res), c)
    _bits_equal(corr, jcorr)
    _bits_equal(new_res, jres)
    assert c.wire_bytes_per_element == jc.wire_bytes_per_element


@pytest.mark.parametrize("W", WORLDS)
@pytest.mark.parametrize("codec", CODECS)
def test_reduce_scatter_matches_reference(W, codec):
    M = W * 128 * 3
    x = _payload(W, M, W)
    jc = _jcodec(codec)
    want = _vmap(lambda v: JC.fractal_reduce_scatter(
        v, ("data",), (W,), codec=jc), x)
    got = C.fractal_reduce_scatter(torch.from_numpy(x), make_codec(codec))
    _bits_equal(got, want)
    # the schedule-dispatched entry point and the engine's layout agree
    _bits_equal(C.reduce_scatter(torch.from_numpy(x), "fractal",
                                 make_codec(codec)), want)


@pytest.mark.parametrize("W", WORLDS)
@pytest.mark.parametrize("codec", CODECS)
def test_all_reduce_matches_reference(W, codec):
    M = W * 128 * 2
    x = _payload(W, M, 10 + W)
    jc = _jcodec(codec)
    want = _vmap(lambda v: JC.fractal_all_reduce(
        v, ("data",), (W,), codec=jc), x)
    got = C.fractal_all_reduce(torch.from_numpy(x), make_codec(codec))
    _bits_equal(got, want)


@pytest.mark.parametrize("W", WORLDS)
def test_all_gather_and_shard_layout_match_reference(W):
    m = 8
    shards = _payload(W, m, 20 + W)
    want = _vmap(lambda v: JC.fractal_all_gather(v, ("data",), (W,)),
                 shards)
    got = C.fractal_all_gather(torch.from_numpy(shards))
    _bits_equal(got, want)
    _bits_equal(C.all_gather_flat(torch.from_numpy(shards)), want)
    # every rank gathers the same payload: rank r's shard at rev(r)
    rev = C.bit_reversed_index(W)
    jrev = _vmap(lambda v: JC.bit_reversed_index(("data",), (W,)),
                 np.zeros(W, np.float32))
    assert rev.tolist() == jrev.tolist()
    flat = got[0].numpy().reshape(W, m)
    for r in range(W):
        assert np.array_equal(flat[rev[r]], shards[r])
        assert np.array_equal(got[r].numpy(), got[0].numpy())


@pytest.mark.parametrize("W", WORLDS)
def test_reduce_scatter_then_gather_is_the_sum(W):
    """rank r's shard is chunk rev(r) of the world sum; the gather puts the
    chunks back in flat order (exact for small integers)."""
    M = W * 128
    x = np.random.default_rng(W).integers(-8, 8, (W, M)).astype(np.float32)
    shard = C.reduce_scatter(torch.from_numpy(x), "fractal")
    out = C.all_gather_flat(shard)
    total = x.sum(0)
    for r in range(W):
        assert np.array_equal(out[r].numpy(), total)


@pytest.mark.parametrize("W", WORLDS)
@pytest.mark.parametrize("level", [None, 0, 1, 2])
def test_barrier_tokens_match_reference(W, level):
    want = _vmap(lambda v: JC.fractal_barrier(("data",), (W,), level=level),
                 np.zeros(W, np.float32))
    got = C.fractal_barrier(W, level=level)
    assert got.tolist() == want.tolist()
    assert got.tolist() == [W if level is None else 1 << level] * W


def test_ir_schedules_raise_and_worlds_are_checked():
    """Every schedule's entry point runs (each == the exact sum over ranks
    on integer payloads), "auto" resolves to the reference's pick, and the
    world and payload checks still raise."""
    from repro.core.bsp import BSPConfig as JBSPConfig
    from repro.core.bsp import resolve_schedule as jresolve
    x = torch.from_numpy(np.random.default_rng(0).integers(
        -7, 8, (4, 512)).astype(np.float32))
    total = x.sum(0).expand_as(x)
    for got in (C.ring_all_reduce(x), C.xy_all_reduce(x, (2, 2)),
                C.naive_all_reduce(x), C.hierarchical_all_reduce(x, 2),
                C.ir_all_reduce(x, C.schedule_ir.build_program("tree", (4,)))):
        assert torch.equal(got, total)
    for schedule in ("ring", "xla"):
        shard = C.reduce_scatter(x, schedule)
        assert torch.equal(C.all_gather_flat(shard), total)
    with pytest.raises(ValueError, match="unknown schedule"):
        C.reduce_scatter(x, "bogus")
    with pytest.raises(ValueError, match="power-of-two"):
        C.fractal_reduce_scatter(torch.zeros(3, 384))
    with pytest.raises(ValueError, match="divisible"):
        C.fractal_reduce_scatter(torch.zeros(4, 6))
    for payload in (1e3, 1e6, 1e9):
        for world in (4, 8):
            assert resolve_schedule(BSPConfig(schedule="auto"), world,
                                    payload) == \
                jresolve(JBSPConfig(schedule="auto"), (world,), payload)
    assert resolve_schedule(BSPConfig(schedule="auto"), 6, 1e6) in \
        ("ring", "xy", "naive")
    assert resolve_schedule(BSPConfig(), 4, 1e6) == "fractal"


@pytest.mark.parametrize("kwargs,err", [
    (dict(schedule="bogus"), "schedule"),
    (dict(bucket_mb=0), "positive"),
    (dict(bucket_mb="big"), "auto"),
    (dict(bucket_codec="fp4"), "bucket_codec"),
])
def test_bsp_config_validation_matches_reference(kwargs, err):
    from repro.core.bsp import BSPConfig as JBSPConfig
    with pytest.raises(ValueError, match=err):
        JBSPConfig(**kwargs)
    with pytest.raises(ValueError, match=err):
        BSPConfig(**kwargs)
