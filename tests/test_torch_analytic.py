"""Port parity: the analytic core (cost model, autotuner, simulator, area,
calibration) and the Table 1 entry point, all ``==`` the reference.

  * links, closed forms, ``program_cost`` (plain and mesh-contention,
    with an outer link), its banded version, barrier costs,
    ``step_features`` and ``overlap_step_cost``;
  * ``rank_schedules``, ``pick_schedule``, ``rank_policies`` (bare and
    ZeRO-1 pricing), ``pick_bucket_policies``, ``pick_bucket_schedules``
    and ``autotune`` (each with one deterministic fake ``measure``) over
    payloads from 1 KB to 1 GB at shapes (4,), (8,), (2, 4) and (6,); the
    codec tables, the fused one being what both resolve to here;
  * the event simulator: Table 1 for every mesh (the pins of
    ``tests/test_table1_regression.py``), the H-tree AMO barrier, the NoC
    replay of every barrier and all-reduce program, a bucket pipeline,
    the FractalSync event model under skew, the scaling sweep;
  * the area model; ``fit_from_samples`` on fixed samples and the
    simulator-parameter search's pieces (the timed ``fit_link_params``
    is ``tests/test_torch_calibrate.py``'s);
  * ``python -m repro_torch.launch.table1`` prints the pinned cycles.
"""

import dataclasses
import random

import pytest

from repro.core import area as JA
from repro.core import autotune as JT
from repro.core import calibrate as JCAL
from repro.core import cost_model as JCM
from repro.core import schedule_ir as JIR
from repro.core import simulator as JSIM
from repro_torch.core import area as A
from repro_torch.core import autotune as AT
from repro_torch.core import calibrate as CAL
from repro_torch.core import cost_model as CM
from repro_torch.core import schedule_ir as IR
from repro_torch.core import simulator as SIM
from repro_torch.launch import table1 as table1_cli

SHAPES = [(4,), (8,), (2, 4), (6,)]
PAYLOADS = [1e3, 1e4, 1e5, 1e6, 1.3e7, 1e8, 2.56e8, 1e9]
PINNED = {"Neighbor": (4, 4, 75, 75), "2x2": (6, 6, 135, 192),
          "4x4": (10, 10, 573, 359), "8x8": (14, 18, 2350, 734),
          "16x16": (18, 34, 9381, 1683)}
PINNED_TREE_AMO = {"Neighbor": 75, "2x2": 192, "4x4": 498, "8x8": 937,
                   "16x16": 1438}
PINNED_NOC = {"fractal": {"2x2": 28, "4x4": 78, "8x8": 144, "16x16": 242},
              "naive": {"2x2": 44, "4x4": 132, "8x8": 452, "16x16": 1668},
              "xy": {"2x2": 70, "4x4": 114, "8x8": 202, "16x16": 378}}
MESHES = {"Neighbor": (1, 2), "2x2": (2, 2), "4x4": (4, 4), "8x8": (8, 8),
          "16x16": (16, 16)}


def _names(shape):
    w = 1
    for n in shape:
        w *= n
    return IR.SCHEDULES if w & (w - 1) == 0 else ("ring", "xy", "naive")


def _link(mod, link):
    return getattr(mod, {CM.MAGIA: "MAGIA", CM.TPU_V5E_ICI: "TPU_V5E_ICI",
                         CM.TPU_DCN: "TPU_DCN"}[link])


def _fake_measure(schedule, payload_bytes=1e6):
    """Deterministic 'timings' that disagree with the model (ring fast)."""
    return {"ring": 1.0, "fractal": 2.0, "xy": 3.0}.get(schedule, 4.0) \
        * (1 + payload_bytes * 1e-9)


def test_links_codec_tables_and_closed_forms_match_reference():
    for link in (CM.MAGIA, CM.TPU_V5E_ICI, CM.TPU_DCN):
        assert dataclasses.astuple(link) == \
            dataclasses.astuple(_link(JCM, link))
    assert CM.TPU_V5E_ICI.name == "v5e-ici"
    assert dataclasses.astuple(CM.TPU_V5E) == dataclasses.astuple(JCM.TPU_V5E)
    assert AT.CODEC_WIRE_RATIO == JT.CODEC_WIRE_RATIO
    assert AT.CODEC_STEP_ALPHAS == JT.CODEC_STEP_ALPHAS
    assert AT.CODEC_STEP_ALPHAS_FUSED == JT.CODEC_STEP_ALPHAS_FUSED
    # the port always fuses the decode-add; the reference resolves to the
    # fused table here too (its kernels dispatch)
    assert AT.codec_step_alphas() == JT.codec_step_alphas() == \
        {"none": 0.0, "bf16": 0.5, "int8": 1.0}
    lk, jlk = CM.TPU_V5E_ICI, JCM.TPU_V5E_ICI
    for n in (1, 2, 4, 8, 16, 64):
        for v in (0.0, 1e3, 1e6, 1e9):
            for fn in ("ring_all_reduce", "fractal_all_reduce",
                       "naive_all_reduce", "tree_all_reduce"):
                assert getattr(CM, fn)(n, v, lk) == \
                    getattr(JCM, fn)(n, v, jlk)
            assert CM.xy_all_reduce(n, 2, v, lk) == \
                JCM.xy_all_reduce(n, 2, v, jlk)
            assert CM.hierarchical_all_reduce(n, 2, v, lk, CM.TPU_DCN) == \
                JCM.hierarchical_all_reduce(n, 2, v, jlk, JCM.TPU_DCN)
        for s in ("fractal", "xy", "naive"):
            assert CM.barrier_cost(n, lk, s) == JCM.barrier_cost(n, jlk, s)
    for n in (4, 16, 64):
        for s in ("fractal", "ring", "xy", "naive", "tree"):
            assert CM.schedule_cost(s, n, 1e6, lk) == \
                JCM.schedule_cost(s, n, 1e6, jlk)
    for v in PAYLOADS:
        band = CM.payload_band(v)
        assert band == JCM.payload_band(v)
        assert CM.band_payload(band) == JCM.band_payload(band)


@pytest.mark.parametrize("shape", SHAPES + [(4, 4), (2, 2, 2)])
def test_program_costs_match_reference(shape):
    for name in _names(shape):
        prog, jprog = IR.build_program(name, shape), \
            JIR.build_program(name, shape)
        for mc in (False, True):
            assert CM.step_features(prog, mc) == JCM.step_features(jprog, mc)
            for outer in (None, "TPU_DCN"):
                o, jo = (None, None) if outer is None else \
                    (CM.TPU_DCN, JCM.TPU_DCN)
                assert CM.program_barrier_cost(
                    prog, CM.MAGIA, o, mc) == JCM.program_barrier_cost(
                        jprog, JCM.MAGIA, jo, mc)
                for v in PAYLOADS:
                    assert CM.program_cost(prog, v, CM.TPU_V5E_ICI, o, mc) \
                        == JCM.program_cost(jprog, v, JCM.TPU_V5E_ICI, jo,
                                            mc)
                    assert CM.program_cost_banded(
                        prog, v, CM.TPU_V5E_ICI, o, mc) == \
                        JCM.program_cost_banded(jprog, v, JCM.TPU_V5E_ICI,
                                                jo, mc)
    names = _names(shape)[:3]
    progs = [IR.build_program(n, shape) for n in names]
    jprogs = [JIR.build_program(n, shape) for n in names]
    args = ([1e6, 3e7, 2e5], [0.0, 1e-4, 2e-4])
    tl = CM.overlap_step_cost(progs, *args, CM.TPU_V5E_ICI,
                              extra_s=[0.0, 1e-6, 2e-6])
    jtl = JCM.overlap_step_cost(jprogs, *args, JCM.TPU_V5E_ICI,
                                extra_s=[0.0, 1e-6, 2e-6])
    assert dataclasses.astuple(tl) == dataclasses.astuple(jtl)
    assert tl.overlap_gain == jtl.overlap_gain


def _policies(ps):
    return [(p.schedule, p.codec, p.predicted_s) for p in ps]


@pytest.mark.parametrize("shape", SHAPES)
def test_rankings_and_picks_match_reference(shape):
    for v in PAYLOADS:
        for mc in (True, False):
            assert AT.rank_schedules(shape, v, mesh_contention=mc) == \
                JT.rank_schedules(shape, v, mesh_contention=mc)
        assert AT.pick_schedule(shape, v) == JT.pick_schedule(shape, v)
        assert AT.rank_schedules(shape, v, CM.MAGIA) == \
            JT.rank_schedules(shape, v, JCM.MAGIA)
        for zero1 in (False, True):
            assert _policies(AT.rank_policies(shape, v,
                                              zero1_publish=zero1)) == \
                _policies(JT.rank_policies(shape, v, zero1_publish=zero1))
        assert _policies(AT.rank_policies(
            shape, v, schedules=("ring", "xy"), codecs=("none", "bf16"))) \
            == _policies(JT.rank_policies(shape, v, schedules=("ring", "xy"),
                                          codecs=("none", "bf16")))
        r, jr = AT.autotune(shape, v), JT.autotune(shape, v)
        assert (r.schedule, r.ranking, r.measured, r.predicted_s) == \
            (jr.schedule, jr.ranking, jr.measured, jr.predicted_s)
        r = AT.autotune(shape, v, measure=_fake_measure)
        jr = JT.autotune(shape, v, measure=_fake_measure)
        assert (r.schedule, r.ranking, r.measured) == \
            (jr.schedule, jr.ranking, jr.measured)
    for zero1 in (False, True):
        assert _policies(AT.pick_bucket_policies(
            shape, PAYLOADS, zero1_publish=zero1)) == \
            _policies(JT.pick_bucket_policies(shape, PAYLOADS,
                                              zero1_publish=zero1))
        for budget in (0, 3, 100):
            kw = dict(zero1_publish=zero1, measure=_fake_measure,
                      measure_budget=budget)
            assert AT.pick_bucket_schedules(shape, PAYLOADS, **kw) == \
                JT.pick_bucket_schedules(shape, PAYLOADS, **kw)
    base = tuple(_names(shape)[-1] for _ in PAYLOADS)
    assert AT.pick_bucket_schedules(
        shape, PAYLOADS, measure=_fake_measure, measure_budget=4,
        baseline=base) == JT.pick_bucket_schedules(
            shape, PAYLOADS, measure=_fake_measure, measure_budget=4,
            baseline=base)


def test_picks_reject_like_reference():
    for mod in (AT, JT):
        with pytest.raises(ValueError, match="no schedule"):
            mod.rank_schedules((6,), 1e6, schedules=("fractal",))
        with pytest.raises(ValueError, match="baseline"):
            mod.pick_bucket_schedules((4,), [1e6, 2e6], baseline=("ring",))


@pytest.fixture(scope="module")
def table1_run():
    """``python -m repro_torch.launch.table1``, in process, once."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        results = table1_cli.main([])
    return results, buf.getvalue()


def test_table1_entry_point_prints_the_pinned_cycles(table1_run):
    results, out = table1_run
    lines = out.splitlines()
    assert len(lines) == 5 * len(PINNED)
    for name, (fs, fsp, naive, xy) in PINNED.items():
        paper = SIM.PAPER_TABLE1[name]
        for scheme, got, ref in (("fsync", fs, paper[0]),
                                 ("fsync_p", fsp, paper[1]),
                                 ("naive", naive, paper[2]),
                                 ("xy", xy, paper[3])):
            assert (f"table1/{name}/{scheme},cycles={got};paper={ref};"
                    f"ratio={got / ref:.2f}") in lines
        assert f"table1/{name}/speedup,sim={min(naive, xy) / fsp:.1f}x;" \
            f"paper={paper[4]}x" in lines
    assert sum(ln.endswith("ratio=1.00") for ln in lines
               if "/fsync" in ln) == 2 * len(PINNED)
    assert SIM.PAPER_TABLE1 == JSIM.PAPER_TABLE1


@pytest.mark.parametrize("name", list(PINNED))
def test_simulator_matches_reference(table1_run, name):
    results, _ = table1_run
    assert results[name] == JSIM.simulate_config(name)
    assert tuple(results[name][k] for k in
                 ("fsync", "fsync_p", "naive", "xy")) == PINNED[name]
    shape = MESHES[name]
    assert SIM.tree_amo_barrier(shape).run() == \
        JSIM.tree_amo_barrier(shape).run() == PINNED_TREE_AMO[name]
    if name not in ("Neighbor", "16x16"):
        for s, pins in PINNED_NOC.items():
            got = SIM.schedule_on_noc(IR.BARRIER_BUILDERS[s](shape))
            want = JSIM.schedule_on_noc(JIR.BARRIER_BUILDERS[s](shape))
            assert dataclasses.astuple(got) == dataclasses.astuple(want)
            assert got.overhead == pins[name]
    tree = SIM.FractalTree(shape)
    tiles = list(tree.tiles())
    skew = {t: (7 * i) % 5 for i, t in enumerate(tiles)}
    for pipelined in (False, True):
        assert SIM.FractalSyncSim(tree, pipelined).run(skew) == \
            JSIM.FractalSyncSim(JSIM.FractalTree(shape), pipelined).run(skew)


def test_noc_replays_and_sweep_match_reference():
    for name in IR.SCHEDULES:
        for shape in [(4,), (2, 4), (4, 4)]:
            assert SIM.software_schedule_latency(name, shape, payload_flits=4) \
                == JSIM.software_schedule_latency(name, shape,
                                                  payload_flits=4)
    progs = [IR.build_program(n, (4, 4)) for n in ("fractal", "ring", "tree")]
    jprogs = [JIR.build_program(n, (4, 4))
              for n in ("fractal", "ring", "tree")]
    kw = dict(payload_flits=[2, 8, 4], ready=[0, 30, 60])
    assert dataclasses.astuple(SIM.pipelined_on_noc(progs, **kw)) == \
        dataclasses.astuple(JSIM.pipelined_on_noc(jprogs, **kw))
    assert SIM.scaling_sweep((2, 4, 32), max_amo_k=4) == \
        JSIM.scaling_sweep((2, 4, 32), max_amo_k=4)


def test_area_matches_reference():
    for k in (2, 4, 8, 16, 32, 64):
        a, ja = A.system_area(k), JA.system_area(k)
        assert dataclasses.astuple(a) == dataclasses.astuple(ja)
        assert (a.total_mm2, a.noc_share, a.fs_share) == \
            (ja.total_mm2, ja.noc_share, ja.fs_share)
    assert A.fs_tile_overhead() == JA.fs_tile_overhead()
    assert A.TILE_BREAKDOWN == JA.TILE_BREAKDOWN
    assert (A.ROUTER_AREA_MM2, A.FS_MODULE_AREA_MM2) == \
        (JA.ROUTER_AREA_MM2, JA.FS_MODULE_AREA_MM2)


def _samples(mod):
    out = []
    for i, sched in enumerate(("fractal", "ring", "tree")):
        for j, elems in enumerate((1 << 10, 1 << 14, 1 << 17, 1 << 20)):
            secs = 2e-6 * (i + 1) + elems * 4 * 1.3e-11 * (1 + 0.1 * j)
            out.append(mod.LinkSample(sched, (8,), elems * 4.0, secs))
    return out


def test_link_fit_matches_reference():
    for mc in (True, False):
        fit = CAL.fit_from_samples(_samples(CAL), mc, name="fitted-test")
        jfit = JCAL.fit_from_samples(_samples(JCAL), mc, name="fitted-test")
        assert dataclasses.astuple(fit.link) == \
            dataclasses.astuple(jfit.link)
        assert fit.residual == jfit.residual
        assert fit.describe() == jfit.describe()
    with pytest.raises(ValueError, match="LinkSample"):
        CAL.fit_from_samples([])


def test_simulator_search_pieces_match_reference():
    assert CAL.TARGETS == JCAL.TARGETS
    assert CAL.SEARCH_SPACE == JCAL.SEARCH_SPACE
    ps = [CAL.random_params(random.Random(s)) for s in range(3)]
    jps = [JCAL.random_params(random.Random(s)) for s in range(3)]
    assert [dataclasses.astuple(p) for p in ps] == \
        [dataclasses.astuple(p) for p in jps]
    nb = [dataclasses.astuple(p) for p in CAL.neighbors(
        CAL.DEFAULT_PARAMS, random.Random(0))]
    jnb = [dataclasses.astuple(p) for p in JCAL.neighbors(
        JCAL.DEFAULT_PARAMS, random.Random(0))]
    assert nb == jnb and len(nb) > 8
    assert CAL.report(CAL.DEFAULT_PARAMS) == JCAL.report(JCAL.DEFAULT_PARAMS)

