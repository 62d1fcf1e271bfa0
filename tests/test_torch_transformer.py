"""Port parity: the model assembler against ``repro.models.transformer``.

The reference's ``init_params`` tree crosses over leaf by leaf through
numpy (``weights.from_jax_params``); chunked paged prefill and then several
batched decode steps run through both packages on the same tokens, block
tables and offsets.  Logits are held to f32 atol 1e-4 (26-op-deep graphs
summed in other orders), the paged pools to atol 1e-5.  Block 0 is the
sentinel: masked rows write garbage there in both packages, so it is left
out of the pool comparison.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import registry as JR
from repro.models import transformer as JT
from repro_torch import weights
from repro_torch.models import registry as R
from repro_torch.models import transformer as T

ARCH = "gemma2-2b-smoke"
LOGIT_ATOL = 1e-4
POOL_ATOL = 1e-5


@pytest.fixture(scope="module")
def jcfg():
    return JR.get_config(ARCH)


@pytest.fixture(scope="module")
def cfg():
    return R.get_config(ARCH)


@pytest.fixture(scope="module")
def jparams(jcfg):
    return JT.init_params(jcfg, jax.random.key(0))


@pytest.fixture(scope="module")
def params(jparams, cfg):
    return weights.from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                                   device="cpu")


@pytest.mark.parametrize("name", ["gemma2-2b", "gemma2-2b-smoke"])
def test_config_and_param_count_match_reference(name):
    ours, ref = R.get_config(name), JR.get_config(name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.segments() == ref.segments()
    assert R.count_params(ours) == JR.count_params(ref)


def test_unported_archs_raise():
    with pytest.raises(NotImplementedError, match="not ported yet"):
        R.get_config("paligemma-3b-smoke")
    with pytest.raises(KeyError):
        R.get_config("nope")


def test_from_jax_params_carries_every_leaf(jparams, params, cfg):
    """Every reference leaf lands, bit for bit, at its port position:
    layer i of gemma2 is segments[0]["l{i%2}"][...][i//2]."""
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    unit = len(cfg.segments()[0][0])
    seen = 0
    for path, leaf in flat:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        leaf = np.asarray(leaf)
        if keys[0] == "segments":
            _seg, lj = keys[1], keys[2]
            j = int(lj[1:])
            for r in range(leaf.shape[0]):
                node = params["layers"][r * unit + j]
                for k in keys[3:]:
                    node = node[k]
                np.testing.assert_array_equal(node.numpy(), leaf[r])
                seen += 1
        else:
            node = params
            for k in keys:
                node = node[k]
            np.testing.assert_array_equal(node.numpy(), leaf)
            seen += 1
    ours = sum(1 for _ in R._leaves(params))
    assert seen == ours
    # and the port's own init builds the same tree shape
    shapes = T.init_params(cfg, device="meta")
    assert jax.tree.map(lambda t: tuple(t.shape), shapes) == \
        jax.tree.map(lambda t: tuple(t.shape), params)


def _pools_close(ours, theirs_np, cfg):
    theirs = weights.unstack_layers(theirs_np, cfg, device="cpu")
    for a, b in zip(ours, theirs):
        for leaf in ("k", "v"):
            np.testing.assert_allclose(a[leaf][1:].numpy(),
                                       b[leaf][1:].numpy(), rtol=0,
                                       atol=POOL_ATOL)


@pytest.mark.parametrize("kernel",
                         ["ref", pytest.param("auto", id="kernel")])
def test_prefill_then_decode_matches_reference(cfg, jcfg, params, jparams,
                                               kernel):
    N, bs, n, C = 16, 4, 6, 4
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=(plen,)).astype(np.int64)
               for plen in (10, 3)]
    tables = np.zeros((3, n), np.int32)
    tables[0, :4] = [5, 2, 9, 12]
    tables[1, :2] = [7, 3]                      # row 2: masked (sentinel)
    jprefill = jax.jit(
        lambda p, t, c, o, bt, wl: JT.prefill_chunk(
            p, jcfg, t, c, o, with_logits=wl, block_tables=bt),
        static_argnums=5)
    jpk = "pallas" if kernel == "auto" else "ref"
    jdecode = jax.jit(lambda p, t, c, o, bt: JT.decode_step(
        p, jcfg, t, c, o, block_tables=bt, paged_kernel=jpk))

    cache = T.init_paged_cache(cfg, N, bs, device="cpu")
    jcache = JT.init_paged_cache(jcfg, N, bs)
    for row, prompt in enumerate(prompts):
        plen = len(prompt)
        starts = [0] if plen <= C else list(range(0, plen - C, C)) + [plen - C]
        for s in starts:
            chunk = np.zeros((1, C), np.int64)
            part = prompt[s:s + C]
            chunk[0, :len(part)] = part
            tab = tables[row:row + 1]
            lg, cache = T.prefill_chunk(params, cfg, torch.from_numpy(chunk),
                                        cache, s, block_tables=torch.from_numpy(
                                            tab))
            jlg, jcache = jprefill(jparams, jnp.asarray(chunk, jnp.int32),
                                   jcache, jnp.asarray(s, jnp.int32),
                                   jnp.asarray(tab), True)
            np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=0,
                                       atol=LOGIT_ATOL)
    _pools_close(cache, jax.tree.map(np.asarray, jcache), cfg)

    lengths = [10, 3]
    toks = np.array([[11], [17], [0]], np.int64)
    sentinel_off = n * bs - 1
    for step in range(4):
        off = np.array(lengths + [sentinel_off], np.int32)
        lg, cache = T.decode_step(params, cfg, torch.from_numpy(toks), cache,
                                  torch.from_numpy(off),
                                  block_tables=torch.from_numpy(tables),
                                  paged_kernel=kernel)
        jlg, jcache = jdecode(jparams, jnp.asarray(toks, jnp.int32), jcache,
                              jnp.asarray(off), jnp.asarray(tables))
        np.testing.assert_allclose(lg[:2].numpy(), np.asarray(jlg)[:2],
                                   rtol=0, atol=LOGIT_ATOL)
        nxt = lg[:, 0].argmax(-1).numpy()
        toks = np.array([[nxt[0]], [nxt[1]], [0]], np.int64)
        lengths = [x + 1 for x in lengths]
    _pools_close(cache, jax.tree.map(np.asarray, jcache), cfg)


def test_copy_block_copies_one_block_in_every_layer(cfg):
    cache = T.init_paged_cache(cfg, 6, 4, device="cpu")
    for layer in cache:
        for pool in layer.values():
            pool.copy_(torch.randn(pool.shape))
    before = [{k: v.clone() for k, v in layer.items()} for layer in cache]
    T.copy_block(cache, 2, 4)
    for b, a in zip(before, cache):
        for k in ("k", "v"):
            torch.testing.assert_close(a[k][4], b[k][2], rtol=0, atol=0)
            keep = [0, 1, 2, 3, 5]
            torch.testing.assert_close(a[k][keep], b[k][keep], rtol=0, atol=0)


def test_prefill_chunk_rejects_blocked_attention_lengths(cfg, params):
    T_len = 2048
    with pytest.raises(ValueError, match="threshold"):
        T.prefill_chunk(params, cfg, torch.zeros(1, T_len, dtype=torch.int64),
                        T.init_paged_cache(cfg, 2, 4, device="cpu"), 0,
                        block_tables=torch.zeros(1, 1, dtype=torch.int32))
