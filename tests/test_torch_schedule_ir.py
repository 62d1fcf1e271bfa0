"""Port parity: the Schedule IR (``repro_torch.core.schedule_ir``, ``tree``).

The port keeps its own copy of the reference's IR, so its dataclasses are
not the reference's: Programs are compared in a canonical form, ``(name,
kind, shape, world, n_chunks)`` plus every step's metadata and its
``(src, dst, chunks, reduce)`` transfers, which must be equal (``==``), as
must ``validate``'s statistics and its rejections.  Every builder runs at
the shapes of ``tests/test_schedule_properties.py`` (the tree-structured
ones at power-of-two worlds, ring/xy/naive at any), every barrier builder
at every fsync level, and the ``FractalTree`` geometry behind them.
"""

import pytest

from repro.core import schedule_ir as JIR
from repro.core import tree as JTREE
from repro_torch.core import schedule_ir as IR
from repro_torch.core import tree as TREE

POW2_SHAPES = [(2,), (4,), (8,), (16,), (32,), (2, 2), (2, 4), (4, 2),
               (4, 4), (8, 2), (2, 8), (8, 8), (2, 2, 2), (4, 2, 2)]
ANY_SHAPES = POW2_SHAPES + [(3,), (6,), (3, 2), (5,), (2, 3), (12,)]
TREE_SCHEDULES = ("fractal", "hierarchical", "tree")


def canon(prog):
    """A Program of either package as plain tuples."""
    steps = tuple(
        (s.level, s.axis, s.tier,
         tuple((t.src, t.dst, tuple(t.chunks), t.reduce)
               for t in s.transfers))
        for s in prog.steps)
    bucket = None if prog.bucket is None else (
        prog.bucket.index, prog.bucket.n_buckets, prog.bucket.offset_elems,
        prog.bucket.length_elems, prog.bucket.codec)
    return (prog.name, prog.kind, tuple(prog.shape), prog.world,
            prog.n_chunks, bucket, steps)


def _cases():
    for name in IR.SCHEDULES:
        for shape in (POW2_SHAPES if name in TREE_SCHEDULES else ANY_SHAPES):
            yield name, shape


def test_registries_match_reference():
    assert IR.SCHEDULES == JIR.SCHEDULES
    assert tuple(IR.BUILDERS) == tuple(JIR.BUILDERS)
    assert tuple(IR.BARRIER_BUILDERS) == tuple(JIR.BARRIER_BUILDERS)
    assert (IR.ALL_REDUCE, IR.BARRIER, IR.TIER_INNER) == \
        (JIR.ALL_REDUCE, JIR.BARRIER, JIR.TIER_INNER)


@pytest.mark.parametrize("name,shape", list(_cases()))
def test_all_reduce_programs_match_reference(name, shape):
    prog, jprog = IR.build_program(name, shape), \
        JIR.build_program(name, shape)
    assert canon(prog) == canon(jprog)
    assert IR.validate(prog) == JIR.validate(jprog)
    assert prog.per_rank_frac_sent() == jprog.per_rank_frac_sent()
    assert prog.describe() == jprog.describe()


def _validated(mod, prog):
    try:
        return mod.validate(prog)
    except mod.ScheduleError as exc:
        return str(exc)


@pytest.mark.parametrize("shape", [(4, 4), (2, 4, 4), (8,), (2, 2)])
def test_barrier_programs_match_reference_at_every_level(shape):
    L = TREE.FractalTree(shape).num_levels
    for name, builder in IR.BARRIER_BUILDERS.items():
        jbuilder = JIR.BARRIER_BUILDERS[name]
        levels = [None] + list(range(L + 1)) \
            if name in ("fractal", "tree") else [None]
        for level in levels:
            kw = {} if level is None else {"level": level}
            prog, jprog = builder(shape, **kw), jbuilder(shape, **kw)
            assert canon(prog) == canon(jprog), (name, level)
            # a barrier below the root reaches only its domain: both
            # validators reject it with the same words
            assert _validated(IR, prog) == _validated(JIR, jprog)
    for bad in (-1, L + 1):
        for mod in (IR, JIR):
            with pytest.raises(mod.ScheduleError, match="outside"):
                mod.butterfly_barrier(shape, level=bad)


def test_bucket_tag_and_geometry_match_reference():
    meta = IR.BucketMeta(2, 5, 1024, 512, "int8")
    jmeta = JIR.BucketMeta(2, 5, 1024, 512, "int8")
    prog = IR.build_program("ring", (8,)).with_bucket(meta)
    jprog = JIR.build_program("ring", (8,)).with_bucket(jmeta)
    assert canon(prog) == canon(jprog)
    assert prog.describe() == jprog.describe()
    for shape in [(4,), (2, 4), (4, 2, 2), (6,), (3, 2)]:
        assert IR.as_2d(shape) == JIR.as_2d(shape)
        for r in range(IR.build_program("ring", shape).world):
            assert IR.rank_coords(shape, r) == JIR.rank_coords(shape, r)
            assert IR.coords_rank(shape, IR.rank_coords(shape, r)) == r
    for shape in POW2_SHAPES:
        assert IR.tree_bit_positions(shape) == JIR.tree_bit_positions(shape)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (4, 4), (8, 8), (16, 16),
                                   (2, 4), (2, 16, 16)])
def test_fractal_tree_matches_reference(shape):
    t, jt = TREE.FractalTree(shape), JTREE.FractalTree(shape)
    assert (t.num_tiles, t.num_levels, t.num_fs_modules) == \
        (jt.num_tiles, jt.num_levels, jt.num_fs_modules)
    assert [(l.level, l.axis, l.bit, l.separation, l.wire_pitches,
             l.pipeline_regs) for l in t.levels] == \
        [(l.level, l.axis, l.bit, l.separation, l.wire_pitches,
          l.pipeline_regs) for l in jt.levels]
    assert t.total_wire_pitches() == jt.total_wire_pitches()
    tiles = list(t.tiles())
    assert tiles == list(jt.tiles())
    for level in [None] + list(range(t.num_levels + 1)):
        for pipelined in (False, True):
            assert t.fsync_latency(level, pipelined) == \
                jt.fsync_latency(level, pipelined)
        assert t.total_pipeline_regs(level) == jt.total_pipeline_regs(level)
    for level in range(1, t.num_levels + 1):
        assert t.domains(level) == jt.domains(level)
        assert t.domain_size(level) == jt.domain_size(level)
        for tile in tiles[:: max(1, len(tiles) // 8)]:
            assert t.partner(tile, level) == jt.partner(tile, level)
            assert t.domain_key(tile, level) == jt.domain_key(tile, level)


def test_named_trees_match_reference():
    assert TREE.neighbor_tree().shape == JTREE.neighbor_tree().shape
    for k in (2, 4, 8, 16):
        assert TREE.square_tree(k).shape == JTREE.square_tree(k).shape


def _bad_programs(mod):
    T, S, P = mod.Transfer, mod.Step, mod.Program
    yield "double", P("bad", (2,), 1, (S((T(0, 1, (0,)),)),
                                       S((T(0, 1, (0,)), T(1, 0, (0,)))))), \
        "double-counted"
    yield "incomplete", P("bad", (2,), 1, (S((T(0, 1, (0,)),)),)), \
        "incomplete"
    yield "twice", P("bad", (3,), 1, (S((T(0, 1, (0,)), T(0, 2, (0,)))),)), \
        "sends twice"


@pytest.mark.parametrize("which", ["double", "incomplete", "twice"])
def test_validator_rejects_like_reference(which):
    for mod in (IR, JIR):
        prog, match = dict((k, (p, m)) for k, p, m in _bad_programs(mod))[
            which]
        with pytest.raises(mod.ScheduleError, match=match):
            mod.validate(prog)
    with pytest.raises(IR.ScheduleError, match="unknown schedule"):
        IR.build_program("bogus", (4,))
