"""Port parity: model building blocks against ``repro.models.layers``.

Same numpy inputs and the reference's own params (converted through
numpy) go through both packages.  Elementwise pieces and the attention and
MLP layers are held to f32 rtol/atol 1e-5 (XLA and PyTorch sum in other
orders); the paged gather/scatter primitives move bits only and must be
exactly equal, sentinel redirects included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models.registry import get_config as jax_get_config
from repro_torch.models import layers as L
from repro_torch.models.registry import get_config
from repro_torch.serve.blocks import SENTINEL

RTOL = ATOL = 1e-5


@pytest.fixture(scope="module")
def cfg():
    return get_config("gemma2-2b-smoke")


@pytest.fixture(scope="module")
def jcfg():
    return jax_get_config("gemma2-2b-smoke")


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def test_paged_sentinel_matches_host_allocator():
    assert L.PAGED_SENTINEL == SENTINEL == JL.PAGED_SENTINEL


def test_rms_norm_rope_softcap():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 32)).astype(np.float32) * 3
    scale = rng.standard_normal((32,)).astype(np.float32)
    pos = rng.integers(0, 500, size=(2, 5)).astype(np.int32)
    _close(L.rms_norm({"scale": torch.from_numpy(scale)},
                      torch.from_numpy(x), 1e-6),
           JL.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6))
    _close(L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4))
    _close(L.softcap(torch.from_numpy(x * 30), 50.0),
           JL.softcap(jnp.asarray(x * 30), 50.0))
    assert torch.equal(L.softcap(torch.from_numpy(x), None),
                       torch.from_numpy(x))


@pytest.mark.parametrize("head_dim,theta", [(256, 10000.0), (64, 10000.0)],
                         ids=["gemma2-2b", "deepseek-v3-rope"])
def test_rope_freqs_equal_the_reference_and_are_computed_once(
        head_dim, theta, monkeypatch):
    """gemma2-2b's head (256) and DeepSeek-V3's rope part (64): the f32
    inverse frequencies equal the reference's bit for bit; a second call
    hands back the kept tensor without computing it again (the decode step
    asks twice per layer, and must not copy to the card each time)."""
    L._ROPE_FREQS.pop((head_dim, theta, torch.device("cpu")), None)
    first = L.rope_freqs(head_dim, theta)
    want = np.asarray(JL.rope_freqs(head_dim, theta))
    assert first.dtype == torch.float32 and first.shape == want.shape
    np.testing.assert_array_equal(first.numpy(), want)

    def no_recompute(*a, **k):
        raise AssertionError("rope_freqs computed again")

    monkeypatch.setattr(torch, "pow", no_recompute)
    assert L.rope_freqs(head_dim, theta) is first
    assert L.rope_freqs(head_dim, theta, device="cpu") is first


@pytest.mark.parametrize("window,cap", [(None, None), (3, 50.0)])
def test_gqa_attention_unchunked(window, cap):
    rng = np.random.default_rng(1)
    B, Tq, Tk, Hq, Hkv, D = 2, 4, 9, 4, 2, 16
    q = rng.standard_normal((B, Tq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Tk, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Tk, Hkv, D)).astype(np.float32)
    pq = np.array([[5, 6, 7, 8], [1, 2, 3, 4]], np.int32)
    pk = np.arange(Tk, dtype=np.int32)[None].repeat(B, 0)
    got = L.gqa_attention(*map(torch.from_numpy, (q, k, v)),
                          pos_q=torch.from_numpy(pq),
                          pos_k=torch.from_numpy(pk), window=window,
                          attn_cap=cap)
    want = JL.gqa_attention(*map(jnp.asarray, (q, k, v)),
                            pos_q=jnp.asarray(pq), pos_k=jnp.asarray(pk),
                            window=window, attn_cap=cap)
    _close(got, want)


def test_apply_mlp_geglu(cfg, jcfg):
    assert cfg.mlp == "geglu"
    p = JL.init_mlp(jax.random.key(3), jcfg)
    x = np.random.default_rng(2).standard_normal(
        (2, 3, cfg.d_model)).astype(np.float32)
    _close(L.apply_mlp(_t(p), cfg, torch.from_numpy(x)),
           JL.apply_mlp(p, jcfg, jnp.asarray(x)), atol=1e-5)


def _pool_case(seed, N=10, bs=4, H=2, D=3, B=3, n=3):
    rng = np.random.default_rng(seed)
    pool = rng.standard_normal((N, bs, H, D)).astype(np.float32)
    tables = np.zeros((B, n), np.int32)
    perm = rng.permutation(np.arange(1, N))
    tables[0, :3] = perm[:3]
    tables[1, :2] = perm[3:5]          # third entry: sentinel padding
    tables[2] = SENTINEL               # masked row: all sentinel
    return rng, pool, tables


def test_paged_gather_exact():
    _, pool, tables = _pool_case(0)
    got = L.paged_gather(torch.from_numpy(pool), torch.from_numpy(tables))
    want = JL.paged_gather(jnp.asarray(pool), jnp.asarray(tables))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("offset,T", [
    (np.array([0, 2, 11], np.int32), 1),    # decode; masked row → sentinel
    (np.array([9, 5, 0], np.int32), 4),     # ragged spans past the table
    (5, 3),                                 # scalar offset (prefill chunk)
    (10, 4),                                # end-padding past the span
])
def test_paged_scatter_exact_with_sentinel_redirects(offset, T):
    rng, pool, tables = _pool_case(1)
    tables[2] = tables[0]                   # no duplicate sentinel writes
    if np.ndim(offset) == 0:
        tables = tables[:1]
    B = tables.shape[0]
    new = rng.standard_normal((B, T) + pool.shape[2:]).astype(np.float32)
    got = L.paged_scatter(torch.from_numpy(pool.copy()),
                          torch.from_numpy(new), torch.from_numpy(tables),
                          torch.as_tensor(offset))
    want = JL.paged_scatter(jnp.asarray(pool), jnp.asarray(new),
                            jnp.asarray(tables), jnp.asarray(offset))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_paged_scatter_masked_rows_only_touch_the_sentinel():
    """Masked decode rows (all-sentinel tables) write only into block 0;
    every live block stays exactly as the reference leaves it."""
    rng, pool, tables = _pool_case(2)
    tables[1] = SENTINEL
    off = np.array([4, 11, 11], np.int32)
    new = rng.standard_normal((3, 1) + pool.shape[2:]).astype(np.float32)
    got = L.paged_scatter(torch.from_numpy(pool.copy()),
                          torch.from_numpy(new), torch.from_numpy(tables),
                          torch.from_numpy(off)).numpy()
    want = np.asarray(JL.paged_scatter(jnp.asarray(pool), jnp.asarray(new),
                                       jnp.asarray(tables),
                                       jnp.asarray(off)))
    np.testing.assert_array_equal(got[1:], want[1:])
    written = {SENTINEL, int(tables[0, 1])}
    untouched = [i for i in range(len(pool)) if i not in written]
    np.testing.assert_array_equal(got[untouched], pool[untouched])
    assert not np.array_equal(got[0], pool[0])


def _attn_setup(cfg, jcfg, seed=0, N=12, bs=4, n=4):
    p = JL.init_attention(jax.random.key(seed), jcfg)
    rng = np.random.default_rng(seed)
    shape = (N, bs, cfg.num_kv_heads, cfg.head_dim)
    kp = rng.standard_normal(shape).astype(np.float32)
    vp = rng.standard_normal(shape).astype(np.float32)
    tables = np.zeros((2, n), np.int32)
    tables[0] = [3, 7, 1, 9]
    tables[1, :3] = [2, 5, 11]
    return p, rng, kp, vp, tables


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("kernel",
                         ["ref", pytest.param("auto", id="kernel")])
def test_paged_apply_attention_decode(cfg, jcfg, window, kernel):
    """T==1 decode: the port's gather lowering ("ref") and the op route
    ("auto": ref.py on CPU tensors) against the reference's ref and
    pallas (interpret) routes."""
    p, rng, kp, vp, tables = _attn_setup(cfg, jcfg)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    off = np.array([13, 9], np.int32)
    got, gkv = L.apply_attention(
        _t(p), cfg, torch.from_numpy(x),
        positions=torch.from_numpy(off[:, None]),
        kv_cache={"k": torch.from_numpy(kp.copy()),
                  "v": torch.from_numpy(vp.copy())},
        cache_offset=torch.from_numpy(off), window=window,
        block_tables=torch.from_numpy(tables), paged_kernel=kernel)
    want, wkv = JL.apply_attention(
        p, jcfg, jnp.asarray(x), positions=jnp.asarray(off[:, None]),
        kv_cache={"k": jnp.asarray(kp), "v": jnp.asarray(vp)},
        cache_offset=jnp.asarray(off), window=window,
        block_tables=jnp.asarray(tables),
        paged_kernel="pallas" if kernel == "auto" else "ref")
    _close(got, want)
    _close(gkv["k"], wkv["k"])
    _close(gkv["v"], wkv["v"])


def test_paged_apply_attention_prefill_chunk(cfg, jcfg):
    """A T>1 prompt chunk at a nonzero offset through the block table."""
    p, rng, kp, vp, tables = _attn_setup(cfg, jcfg, seed=1)
    T, off = 6, 5
    x = rng.standard_normal((1, T, cfg.d_model)).astype(np.float32)
    pos = (off + np.arange(T, dtype=np.int32))[None]
    got, gkv = L.apply_attention(
        _t(p), cfg, torch.from_numpy(x), positions=torch.from_numpy(pos),
        kv_cache={"k": torch.from_numpy(kp.copy()),
                  "v": torch.from_numpy(vp.copy())},
        cache_offset=off, window=cfg.sliding_window,
        block_tables=torch.from_numpy(tables[:1]))
    want, wkv = JL.apply_attention(
        p, jcfg, jnp.asarray(x), positions=jnp.asarray(pos),
        kv_cache={"k": jnp.asarray(kp), "v": jnp.asarray(vp)},
        cache_offset=jnp.asarray(off, jnp.int32),
        window=jcfg.sliding_window, block_tables=jnp.asarray(tables[:1]))
    _close(got, want)
    _close(gkv["k"], wkv["k"])


def test_apply_attention_no_cache_and_contiguous_guard(cfg, jcfg):
    p, rng, *_ = _attn_setup(cfg, jcfg, seed=2)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    pos = np.arange(7, dtype=np.int32)
    got, _ = L.apply_attention(_t(p), cfg, torch.from_numpy(x),
                               positions=torch.from_numpy(pos), window=3)
    want, _ = JL.apply_attention(p, jcfg, jnp.asarray(x),
                                 positions=jnp.asarray(pos), window=3)
    _close(got, want)
    # the contiguous cache (ported in slice 10; it raised before): one
    # decode token per row at per-row offsets, into the reference's cache
    kc = rng.standard_normal((2, 8, 2, 32)).astype(np.float32)
    vc = rng.standard_normal((2, 8, 2, 32)).astype(np.float32)
    off = np.array([3, 6], np.int32)
    got, gkv = L.apply_attention(
        _t(p), cfg, torch.from_numpy(x[:, :1]),
        positions=torch.from_numpy(off[:, None]),
        kv_cache={"k": torch.from_numpy(kc.copy()),
                  "v": torch.from_numpy(vc.copy())},
        cache_offset=torch.from_numpy(off))
    want, wkv = JL.apply_attention(
        p, jcfg, jnp.asarray(x[:, :1]), positions=jnp.asarray(off[:, None]),
        kv_cache={"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
        cache_offset=jnp.asarray(off))
    _close(got, want)
    _close(gkv["k"], wkv["k"])
    _close(gkv["v"], wkv["v"])
