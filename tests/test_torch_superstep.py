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
                        BSPConfig(**kw), world, force_dtype=torch.float32,
                        zero1=True)
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


def _fake_measure(schedule, payload_bytes):
    """Deterministic 'timings' that disagree with the model (ring fast)."""
    return {"ring": 1.0, "tree": 1.5, "fractal": 2.0}.get(schedule, 4.0) \
        * (1 + payload_bytes * 1e-9)


def _plan(eng):
    return ([(b.index, b.leaf_ids, b.raw, b.offset, b.length)
             for b in eng.buckets],
            eng.schedules, eng.codec_names, eng.describe(),
            eng.total_padded, eng.link.name)


def _timeline(tl):
    return (tl.ready_s, tl.comm_start_s, tl.comm_end_s, tl.comm_cost_s,
            tl.overlapped_s, tl.serial_s)


@pytest.mark.parametrize("kw,what", [
    (dict(schedule="auto"), "schedule='auto'"),
    (dict(bucket_mb="auto"), "bucket_mb='auto'"),
    (dict(bucket_codec="auto"), "bucket_codec='auto'"),
])
def test_cost_model_paths_raise(kw, what):
    """Each cost-model path (``what``) builds the reference's plan on a
    one-leaf engine, and ``refined``/``timeline`` equal the reference's."""
    specs = [(4,), (300,), (2, 64)]
    eng = S.SuperstepEngine([S.LeafSpec(sh, "float32") for sh in specs],
                            BSPConfig(**kw), 4, zero1=True)
    jeng = JS.SuperstepEngine([JS.LeafSpec(sh, "float32") for sh in specs],
                              JBSPConfig(**kw), (4,), zero1=True)
    assert _plan(eng) == _plan(jeng), what
    for t in (0.0, 1e-4):
        assert _timeline(eng.timeline(t)) == _timeline(jeng.timeline(t))
    ref, jref = eng.refined(_fake_measure, 3), jeng.refined(_fake_measure, 3)
    assert _plan(ref) == _plan(jref)


AUTO_KW = [dict(schedule="auto", bucket_mb="auto", bucket_codec="auto"),
           dict(schedule="auto", bucket_mb=0.05),
           dict(bucket_codec="auto", bucket_mb=0.05),
           dict(schedule="auto", bucket_mb="auto", bucket_codec="auto",
                pad_align=64),
           dict(schedule="ring", bucket_mb=0.05, bucket_codec="int8"),
           dict(schedule="xla", bucket_mb="auto")]


@pytest.mark.parametrize("world", [4, 8])
@pytest.mark.parametrize("kw", AUTO_KW)
def test_autotuned_plan_matches_reference(ref_params, port_params, world,
                                          kw):
    """Buckets, per-bucket schedules and codec names, the DP search's
    source and objective, the bucket-tagged programs and the overlap
    timeline of the gemma2-2b-smoke leaves under every auto value."""
    jeng, peng = _engines(ref_params, port_params, world, **kw)
    assert _plan(peng) == _plan(jeng)
    if jeng.plan is None:
        assert peng.plan is None
    else:
        assert (peng.plan.source, peng.plan.objective_s,
                peng.plan.backward_s) == (jeng.plan.source,
                                          jeng.plan.objective_s,
                                          jeng.plan.backward_s)
    if "xla" not in peng.schedules:
        assert [(p.name, p.bucket.index, p.bucket.offset_elems,
                 p.bucket.length_elems, p.bucket.codec)
                for p in peng.programs()] == \
            [(p.name, p.bucket.index, p.bucket.offset_elems,
              p.bucket.length_elems, p.bucket.codec)
             for p in jeng.programs()]
        for t in (0.0, 2e-3):
            assert _timeline(peng.timeline(t)) == \
                _timeline(jeng.timeline(t))
    if kw.get("schedule") != "ring":
        assert set(peng.codec_names) <= {"none", "bf16", "int8"}
    else:
        assert set(peng.codec_names) == {"none"}   # normalised away
    for budget in (0, 2, 100):
        assert _plan(peng.refined(_fake_measure, budget)) == \
            _plan(jeng.refined(_fake_measure, budget))


def test_dp_partition_matches_reference():
    sizes = [300, 1200, 50, 800, 4096, 7, 640, 2000]
    order = tuple(reversed(range(len(sizes))))

    def cost(by):
        return 1e-6 + by / 5e10

    for bw in (None, 0.0, 1e-5, 1e-3):
        p = S.search_bucket_partition(sizes, order, 512, 4, cost, bw)
        jp = JS.search_bucket_partition(sizes, order, 512, 4, cost, bw)
        assert [(b.leaf_ids, b.raw, b.offset, b.length) for b in p.buckets] \
            == [(b.leaf_ids, b.raw, b.offset, b.length) for b in jp.buckets]
        assert (p.objective_s, p.source, p.backward_s) == \
            (jp.objective_s, jp.source, jp.backward_s)
        assert S.partition_objective(p.buckets, cost, 4, 1e-4) == \
            JS.partition_objective(jp.buckets, cost, 4, 1e-4)
    dp = S.dp_partition(sizes, order, 512, 4, cost, 1e-4)
    jdp = JS.dp_partition(sizes, order, 512, 4, cost, 1e-4)
    assert [b.leaf_ids for b in dp] == [b.leaf_ids for b in jdp]


@pytest.mark.parametrize("schedule", ["ring", "tree", "xy"])
def test_bucketed_sync_of_other_schedules_matches_reference(schedule):
    """``sync_gradients`` with a non-fractal schedule equals the
    reference's (its IR lowering, its ppermute completed as in
    ``test_torch_ir_collectives.py``), bit for bit."""
    from test_torch_ir_collectives import _FullPermLax
    from repro.core import collectives as JC
    W = 4
    rng = np.random.default_rng(5)
    shapes = [(3, 40), (257,), (130,)]
    grads = [rng.standard_normal((W,) + s).astype(np.float32)
             for s in shapes]
    kw = dict(schedule=schedule, bucket_mb=0.002)
    real = JC.lax
    JC.lax = _FullPermLax()
    try:
        want = jax.jit(jax.vmap(
            lambda *g: jsync(list(g), JBSPConfig(**kw), (W,)),
            axis_name="data"))(*[jnp.asarray(g) for g in grads])
    finally:
        JC.lax = real
    got = sync_gradients([torch.from_numpy(g) for g in grads],
                         BSPConfig(**kw), W)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().view(np.uint32),
                              np.asarray(w).view(np.uint32))
