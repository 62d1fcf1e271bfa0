"""Port parity: every schedule's lowering on the rank-stacked tensor.

``ir_all_reduce`` (through ``all_reduce``) and ``reduce_scatter`` of every
Schedule-IR schedule at worlds 4 and 8 equal, bit for bit, the reference's
lowering run under ``jax.jit(jax.vmap(..., axis_name="data"))`` on the same
random f32 payload.  ``jax.vmap`` lowers ``lax.ppermute`` only for full
permutations, and most IR steps are partial (a tree's leaves idle while
the root receives), so the reference's ``lax`` is given a ``ppermute``
that completes each step's permutation with pairs from its idle senders to
its idle receivers; the reference masks those receives out (``is_dst``),
so its arithmetic is unchanged.  At mesh shapes vmap cannot carry (2-D
meshes, world 6) the port is held to an f32 ``execute_dense`` (the dense
executor of ``tests/test_schedule_properties.py``: all sends of a step
stage before any receive, reduce ``+=``, copy overwrites), bit for bit.
The hand-rolled ring/naive lowerings equal the reference's too; xy and
hierarchical equal the exact sum on integer payloads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.core import collectives as JC
from repro_torch.core import collectives as C
from repro_torch.core import schedule_ir as IR
from repro_torch.optim.compression import Int8Codec

WORLDS = [4, 8]


class _FullPermLax:
    """``jax.lax`` with a ``ppermute`` that vmap can lower: the step's
    partial permutation completed by idle-sender → idle-receiver pairs."""

    def __getattr__(self, name):
        return getattr(lax, name)

    @staticmethod
    def ppermute(x, axis_name, perm):
        n = lax.psum(1, axis_name)
        srcs = {s for s, _ in perm}
        dsts = {d for _, d in perm}
        rest = zip([i for i in range(n) if i not in srcs],
                   [i for i in range(n) if i not in dsts])
        return lax.ppermute(x, axis_name, list(perm) + list(rest))


@pytest.fixture
def vmap_ref(monkeypatch):
    monkeypatch.setattr(JC, "lax", _FullPermLax())

    def run(fn, x):
        out = jax.jit(jax.vmap(fn, axis_name="data"))(jnp.asarray(x))
        return jax.tree.map(np.asarray, out)
    return run


def _payload(W, M, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((W, M)) * np.exp(rng.standard_normal((W, M)))
    return x.astype(np.float32)


def _ints(W, M, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-7, 8, (W, M)).astype(np.float32)


def _bits_equal(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), \
        f"max diff {np.abs(got - want).max()}"


def execute_dense_f32(prog, payload):
    """``execute_dense`` in f32: ``payload`` is ``[W, n_chunks, chunk]``."""
    state = payload.copy()
    for step in prog.steps:
        staged = [(t, state[t.src][list(t.chunks)].copy())
                  for t in step.transfers]
        for t, data in staged:
            idx = list(t.chunks)
            if t.reduce:
                state[t.dst][idx] += data
            else:
                state[t.dst][idx] = data
    return state


@pytest.mark.parametrize("W", WORLDS)
@pytest.mark.parametrize("schedule", IR.SCHEDULES)
def test_lowering_matches_jitted_reference(vmap_ref, W, schedule):
    M = W * 128 * 3
    x = _payload(W, M, W)
    want_ar, want_rs = vmap_ref(
        lambda v: (JC.all_reduce(v, schedule, ("data",), (W,)),
                   JC.reduce_scatter(v, schedule, ("data",), (W,))), x)
    xt = torch.from_numpy(x)
    _bits_equal(C.all_reduce(xt, schedule), want_ar)
    _bits_equal(C.reduce_scatter(xt, schedule), want_rs)
    _bits_equal(C.ir_all_reduce(xt, IR.build_program(schedule, (W,))),
                want_ar)


@pytest.mark.parametrize("W", WORLDS)
def test_hand_rolled_lowerings_match_reference(vmap_ref, W):
    M = W * 128 * 3
    x = _payload(W, M, 10 + W)
    want_ring, want_naive = vmap_ref(
        lambda v: (JC.ring_all_reduce(v, "data", W),
                   JC.naive_all_reduce(v, ("data",), (W,))), x)
    xt = torch.from_numpy(x)
    _bits_equal(C.ring_all_reduce(xt), want_ring)
    _bits_equal(C.naive_all_reduce(xt), want_naive)
    xi = _ints(W, M, W)
    full = np.broadcast_to(xi.sum(0), xi.shape)
    shape = (2, W // 2)
    xt = torch.from_numpy(xi)
    assert np.array_equal(C.xy_all_reduce(xt, shape).numpy(), full)
    assert np.array_equal(C.hierarchical_all_reduce(xt, W // 2).numpy(),
                          full)
    # a ring along mesh axis 1 sums each row of the mesh on its own
    rows = xi.reshape(2, W // 2, M).sum(1, keepdims=True)
    assert np.array_equal(C.ring_all_reduce(xt, shape, axis=1).numpy(),
                          np.broadcast_to(rows, (2, W // 2, M))
                          .reshape(W, M))


@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (2, 2, 2), (6,), (3, 2),
                                   (2, 3), (5,)])
def test_lowering_matches_dense_executor(shape):
    W = int(np.prod(shape))
    pow2 = W & (W - 1) == 0
    names = IR.SCHEDULES if pow2 else ("ring", "xy", "naive")
    M = W * 128 * 2
    x = _payload(W, M, W + len(shape))
    for name in names:
        prog = IR.build_program(name, shape)
        want = execute_dense_f32(prog, x.reshape(W, prog.n_chunks, -1))
        got = C.all_reduce(torch.from_numpy(x), name, shape)
        _bits_equal(got, want.reshape(W, M))
        if pow2:
            if name == "fractal":
                # the native reduce-scatter halves along the flat rank's
                # bits, LSB first, whatever the mesh shape: the 1-D
                # butterfly's order (the IR's 2-D butterfly follows the
                # H-tree's axis order)
                flat = IR.build_program(name, (W,))
                want = execute_dense_f32(
                    flat, x.reshape(W, flat.n_chunks, -1))
            rev = C.bit_reversed_index(W).numpy()
            rs = C.reduce_scatter(torch.from_numpy(x), name, shape=shape)
            _bits_equal(rs, want.reshape(W, W, -1)[np.arange(W), rev])


def test_xla_schedule_is_the_sum_over_ranks(vmap_ref):
    W, M = 8, 8 * 128
    xi = _ints(W, M, 3)
    want = vmap_ref(lambda v: JC.all_reduce(v, "xla", ("data",), (W,)), xi)
    got = C.all_reduce(torch.from_numpy(xi), "xla")
    _bits_equal(got, want)
    rs = C.reduce_scatter(torch.from_numpy(xi), "xla")
    rev = C.bit_reversed_index(W).numpy()
    _bits_equal(rs, xi.sum(0).reshape(W, -1)[rev])


def test_codec_is_normalised_away_off_the_fractal_schedule(monkeypatch):
    calls = []
    monkeypatch.setattr(C, "decode_add",
                        lambda *a: calls.append(a) or None)
    x = torch.from_numpy(_payload(4, 4 * 128 * 2, 7))
    for name in ("ring", "xy", "naive", "hierarchical", "tree"):
        assert torch.equal(C.reduce_scatter(x, name, codec=Int8Codec()),
                           C.reduce_scatter(x, name))
    assert calls == []


def test_step_tables_are_cached_per_device():
    prog = IR.build_program("tree", (8,))
    x = torch.zeros(8, 8 * 128)
    C.ir_all_reduce(x, prog)
    C.ir_all_reduce(x.to("meta"), prog)
    cpu, meta = C._program_tables(prog, "cpu"), \
        C._program_tables(prog, "meta")
    assert len(cpu) == len(meta) == sum(1 for s in prog.steps
                                        if s.transfers)
    assert all(t[0].device.type == "cpu" for t in cpu)
    assert all(t[0].device.type == "meta" for t in meta)
    assert C._program_tables(prog, str(x.device)) is cpu


def test_step_tables_refuse_a_mixed_step():
    """Every builder's steps reduce or copy; a step that mixes the two has
    no lowering and is refused before any table is built."""
    import dataclasses
    for name in IR.SCHEDULES:
        for st in IR.build_program(name, (8,)).steps:
            assert len({t.reduce for t in st.transfers}) <= 1, name
    st = IR.build_program("ring", (4,)).steps[0]
    ts = st.transfers
    mixed = dataclasses.replace(st, transfers=(
        dataclasses.replace(ts[0], reduce=not ts[0].reduce),) + ts[1:])
    with pytest.raises(ValueError, match="mixes reduce and copy"):
        C._step_tables(mixed)


def test_sync_domains_and_scope_match_reference():
    """fsync domains on the rank-stacked world: every rank's token is its
    domain's size, and ``SyncScope`` flags the level mismatches the
    reference's does (its scope needs only the mesh's tree)."""
    import types
    from repro.core import barrier as JB
    from repro.core.tree import FractalTree as JFractalTree
    from repro_torch.core import barrier as B
    for sizes in [(8,), (2, 4)]:
        mesh = B.SyncDomainMesh(sizes)
        assert (mesh.world, mesh.num_levels) == \
            (8, JFractalTree(sizes).num_levels)
        for level in [None] + list(range(mesh.num_levels + 1)):
            assert mesh.fsync(level).tolist() == \
                [mesh.domain_size(level)] * 8
        y = torch.arange(4.0)
        assert B.barrier_tie(y, mesh.fsync()) is y
        jmesh = types.SimpleNamespace(tree=JFractalTree(sizes))
        requests = [((0,) * len(sizes), 1), ((0,) * len(sizes), 2),
                    ((1,) * len(sizes), 1), (tuple(sizes[:-1]) + (0,), 3),
                    ((0,) * len(sizes), 9)]
        for i in range(len(requests)):
            outcomes = []
            for mod, m in ((B, mesh), (JB, jmesh)):
                scope = mod.SyncScope(m)
                try:
                    for key, level in requests[:i + 1]:
                        scope.request(key, level)
                    outcomes.append(dict(scope.active))
                except mod.FSyncError as exc:
                    outcomes.append(str(exc))
            assert outcomes[0] == outcomes[1], requests[:i + 1]


def test_worlds_shapes_and_programs_are_checked():
    with pytest.raises(ValueError, match="unknown schedule"):
        C.all_reduce(torch.zeros(4, 512), "bogus")
    with pytest.raises(ValueError, match="mesh shape"):
        C.all_reduce(torch.zeros(4, 512), "ring", (2, 4))
    with pytest.raises(ValueError, match="power-of-two"):
        C.reduce_scatter(torch.zeros(6, 768), "ring")
    with pytest.raises(ValueError, match="power-of-two"):
        C.all_reduce(torch.zeros(6, 768), "fractal")
    with pytest.raises(ValueError, match="divisible"):
        C.all_reduce(torch.zeros(4, 6), "ring")
    with pytest.raises(ValueError, match="cannot lower"):
        C.ir_all_reduce(torch.zeros(4, 512), IR.butterfly_barrier((4,)))
    with pytest.raises(ValueError, match="program"):
        C.ir_all_reduce(torch.zeros(4, 512), IR.build_program("ring", (8,)))
