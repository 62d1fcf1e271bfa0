"""Port parity: the SuperstepEngine's flat layout against the reference's.

The port lists its per-layer params in the reference's
``jax.tree.leaves(params)`` order with layer-stacked shapes
(``weights.reference_leaves``); from there the engine's buckets, shard
offsets and description must equal the reference ``engine_for``'s, and
``pack`` must equal the reference's flat vectors bit for bit (same params,
loaded through numpy).  ``unpack`` restores the leaves, and the bucketed
``sync_gradients`` equals the reference's under ``jax.vmap`` (codecs
none/bf16/int8), bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import superstep as JS
from repro.core.bsp import BSPConfig as JBSPConfig, sync_gradients as jsync
from repro.models import transformer as JT
from repro.models.registry import get_config as jget_config
from repro_torch.core import superstep as S
from repro_torch.core.bsp import BSPConfig, sync_gradients
from repro_torch.models.registry import get_config
from repro_torch.weights import from_jax_params, reference_leaves

ARCH = "gemma2-2b-smoke"


@pytest.fixture(scope="module")
def ref_params():
    return JT.init_params(jget_config(ARCH), jax.random.key(0))


@pytest.fixture(scope="module")
def port_params(ref_params):
    np_tree = jax.tree.map(np.asarray, ref_params)
    return from_jax_params(np_tree, get_config(ARCH), device="cpu")


def _engines(ref_params, port_params, world, **kw):
    jeng = JS.engine_for(ref_params, JBSPConfig(**kw), (world,),
                         force_dtype=jnp.float32, zero1=True)
    peng = S.engine_for(reference_leaves(port_params, get_config(ARCH)),
                        BSPConfig(**kw), world, force_dtype=torch.float32)
    return jeng, peng


def test_leaf_order_and_shapes_match_reference(ref_params, port_params):
    jleaves = jax.tree.leaves(ref_params)
    pleaves = reference_leaves(port_params, get_config(ARCH))
    assert [tuple(l.shape) for l in jleaves] == [l.shape for l in pleaves]
    assert [l.dtype.name for l in jleaves] == \
        [S.dtype_name(l.dtype) for l in pleaves]
    paths = [l.path for l in pleaves]
    assert paths[:2] == ["embed", "final_norm/scale"]
    assert all(p.startswith("segments/0/l") for p in paths[2:])
    for jl, pl in zip(jleaves, pleaves):
        flat = torch.cat([t.reshape(-1) for t in pl.parts]).numpy()
        assert np.array_equal(flat, np.asarray(jl).reshape(-1))


@pytest.mark.parametrize("world", [4, 8])
@pytest.mark.parametrize("kw", [dict(), dict(bucket_mb=0.05),
                                dict(bucket_mb=0.05, bucket_codec="int8"),
                                dict(bucket_mb=0.2, compression="bf16"),
                                dict(bucket_mb=0.05, overlap=False)])
def test_bucket_plan_matches_reference(ref_params, port_params, world, kw):
    jeng, peng = _engines(ref_params, port_params, world, **kw)
    assert peng.buckets == tuple(
        S.Bucket(b.index, b.leaf_ids, b.raw, b.offset, b.length)
        for b in jeng.buckets)
    assert peng.total_padded == jeng.total_padded
    assert peng.shard_offsets() == jeng.shard_offsets()
    assert [peng.shard_len(b) for b in peng.buckets] == \
        [jeng.shard_len(b) for b in jeng.buckets]
    assert peng.codec_names == jeng.codec_names
    assert peng.describe() == jeng.describe()
    assert peng.link_name == jeng.link.name


@pytest.mark.parametrize("world", [4, 8])
def test_pack_matches_reference_and_unpack_restores(ref_params, port_params,
                                                   world):
    jeng, peng = _engines(ref_params, port_params, world, bucket_mb=0.05)
    jparts = jeng.pack(jax.tree.leaves(ref_params), dtype=jnp.float32)
    leaves = reference_leaves(port_params, get_config(ARCH))
    parts = peng.pack(leaves, dtype=torch.float32)
    assert len(parts) == len(jparts)
    for p, jp in zip(parts, jparts):
        assert np.array_equal(p.numpy().view(np.uint32),
                              np.asarray(jp).view(np.uint32))
    back = peng.unpack(parts, leaves)
    for leaf, b in zip(leaves, back):
        assert b.shape == leaf.shape and b.dtype == leaf.dtype
        stacked = leaf.path.startswith("segments/")
        assert torch.equal(b, torch.stack(leaf.parts) if stacked
                           else leaf.parts[0])


@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
def test_bucketed_sync_matches_reference(codec):
    """Rank-stacked gradients through ``sync_gradients`` equal the
    reference's ``sync_gradients`` under ``jax.vmap``, bit for bit."""
    W = 4
    rng = np.random.default_rng(3)
    shapes = [(3, 40), (257,), (2, 8, 16), (130,)]
    grads = [rng.standard_normal((W,) + s).astype(np.float32)
             for s in shapes]
    kw = dict(bucket_mb=0.002,
              bucket_codec=None if codec == "none" else codec)
    want = jax.jit(jax.vmap(
        lambda *g: jsync(list(g), JBSPConfig(**kw), (W,)),
        axis_name="data"))(*[jnp.asarray(g) for g in grads])
    got = sync_gradients([torch.from_numpy(g) for g in grads],
                         BSPConfig(**kw), W)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().view(np.uint32),
                              np.asarray(w).view(np.uint32))


@pytest.mark.parametrize("kw,what", [
    (dict(schedule="auto"), "schedule='auto'"),
    (dict(bucket_mb="auto"), "bucket_mb='auto'"),
    (dict(bucket_codec="auto"), "bucket_codec='auto'"),
])
def test_cost_model_paths_raise(kw, what):
    with pytest.raises(NotImplementedError, match=what):
        S.SuperstepEngine([S.LeafSpec((4,), "float32")], BSPConfig(**kw), 4)
    eng = S.SuperstepEngine([S.LeafSpec((4,), "float32")], BSPConfig(), 4)
    for fn in (eng.refined, eng.timeline):
        with pytest.raises(NotImplementedError, match="autotuner"):
            fn()
