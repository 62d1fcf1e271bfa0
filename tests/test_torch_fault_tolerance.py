"""Port parity: the fault-tolerance host logic (ROADMAP A6), ``==`` the
reference on the reference tests' cases and on seeded sweeps.

  * ``runtime/chaos.py``: ``FaultPlan.parse``, ``spec()`` round trips,
    every query, ``random(seed)`` and the refusals; ``StepClock`` driving a
    ``HostMonitor``;
  * ``runtime/fault_tolerance.py``: ``HostMonitor`` timeouts,
    ``StragglerTracker`` stragglers and ``rebalanced_shares`` over random
    durations, ``surviving_domain`` over random failure sets;
  * ``runtime/elastic.py``: ``plan_recovery`` (``ElasticPlan`` field by
    field) and ``surviving_ranks``, the flat rank order of the reference's
    ``build_mesh_from_tiles``;
  * ``runtime/loop.py``: per-rank durations feed the tracker, the
    rebalance hint is surfaced and actuated only when it changes, and a
    failed host raises ``WorkerFailure``.
"""

import dataclasses

import numpy as np
import pytest

from repro.core.tree import FractalTree as JTree
from repro.runtime import chaos as JC
from repro.runtime import elastic as JE
from repro.runtime import fault_tolerance as JF
from repro_torch.core.tree import FractalTree
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.registry import get_config
from repro_torch.runtime import chaos as C
from repro_torch.runtime import elastic as E
from repro_torch.runtime import fault_tolerance as F
from repro_torch.runtime.loop import LoopConfig, TrainLoop, WorkerFailure

SPEC = ("kill:rank=2,step=300;"
        "slow:rank=3,factor=2.5,steps=100..140;"
        "drop_hb:host=1,steps=50..60;"
        "dup_hb:host=0,step=75;"
        "stall:steps=200..220;"
        "blocks:frac=0.5,steps=150..200")


def _events(plan):
    return [dataclasses.astuple(e) for e in plan.events]


@pytest.mark.parametrize("spec", [SPEC, "", "slow:rank=0,factor=2,steps=0"
                                  "..10;slow:rank=0,factor=3,steps=5..8",
                                  "stall:steps=7..8", "stall:steps=7..19",
                                  "kill:rank=5,step=12;slow:rank=3,factor=3.0,"
                                  "steps=4..10"])
def test_parse_spec_and_queries_equal_reference(spec):
    ours, ref = C.FaultPlan.parse(spec), JC.FaultPlan.parse(spec)
    assert _events(ours) == _events(ref)
    assert ours.spec() == ref.spec()
    assert C.FaultPlan.parse(ours.spec()).spec() == ours.spec()
    assert bool(ours) == bool(ref)
    assert ours.fault_windows() == ref.fault_windows()
    assert ours.first_fault_start() == ref.first_fault_start()
    assert ours.last_fault_end() == ref.last_fault_end()
    for step in range(0, 320, 3):
        assert ours.kills_at(step) == ref.kills_at(step)
        assert ours.killed_by(step) == ref.killed_by(step)
        assert ours.admission_stalled(step) == ref.admission_stalled(step)
        assert ours.block_pressure(step) == ref.block_pressure(step)
        for r in range(6):
            assert ours.slow_factor(r, step) == ref.slow_factor(r, step)
            assert ours.heartbeat_dropped(r, step) == \
                ref.heartbeat_dropped(r, step)
            assert ours.heartbeat_duplicated(r, step) == \
                ref.heartbeat_duplicated(r, step)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("steps,ranks", [(2000, 8), (22, 8), (40, 4)])
def test_random_plans_equal_reference(seed, steps, ranks):
    ours = C.FaultPlan.random(seed, steps, ranks)
    ref = JC.FaultPlan.random(seed, steps, ranks)
    assert _events(ours) == _events(ref)
    assert ours.spec() == ref.spec()


@pytest.mark.parametrize("bad", [
    "melt:rank=1,step=3", "kill:rank=1", "kill:rank=1,steps=5",
    "slow:rank=1,factor=0.5,steps=1..2", "slow:factor=2,steps=1..2",
    "blocks:frac=1.5,steps=1..2", "stall:steps=5..5", "kill:rank 1,step=3",
])
def test_bad_specs_raise_like_reference(bad):
    with pytest.raises(ValueError):
        JC.FaultPlan.parse(bad)
    with pytest.raises(ValueError):
        C.FaultPlan.parse(bad)


def test_step_clock_drives_host_monitor():
    for mod_c, mod_f in ((C, F), (JC, JF)):
        clock = mod_c.StepClock(step_s=1.0)
        mon = mod_f.HostMonitor(num_hosts=2, timeout_s=3.0, clock=clock)
        mon.heartbeat(0)
        mon.heartbeat(1)
        clock.tick(3)
        assert mon.failed_hosts() == set()
        mon.heartbeat(0)
        clock.tick()
        assert mon.failed_hosts() == {1}
        assert clock() == clock.now() == 4.0


def test_host_monitor_equals_reference():
    rng = np.random.default_rng(0)
    ours = F.HostMonitor(num_hosts=6, timeout_s=10.0)
    ref = JF.HostMonitor(num_hosts=6, timeout_s=10.0)
    now = 100.0
    for _ in range(40):
        now += float(rng.uniform(0, 6))
        for h in rng.choice(6, size=int(rng.integers(0, 6)), replace=False):
            ours.heartbeat(int(h), now=now)
            ref.heartbeat(int(h), now=now)
        assert ours.failed_hosts(now=now) == ref.failed_hosts(now=now)
        assert ours.healthy(now=now) == ref.healthy(now=now)
    with pytest.raises(ValueError):
        ours.heartbeat(6, now=now)


@pytest.mark.parametrize("seed", range(12))
def test_stragglers_and_rebalanced_shares_equal_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 12))
    durations = rng.uniform(0.05, 50.0, size=n)
    ours, ref = F.StragglerTracker(window=4), JF.StragglerTracker(window=4)
    for _ in range(3):
        for r, d in enumerate(durations):
            jitter = float(rng.uniform(0.9, 1.1))
            ours.record(r, float(d) * jitter)
            ref.record(r, float(d) * jitter)
    assert ours.stragglers() == ref.stragglers()
    ranks = list(range(n))
    for total in (n, n + 3, 4 * n, 16):
        if total < n:
            continue
        assert ours.rebalanced_shares(ranks, total) == \
            ref.rebalanced_shares(ranks, total)
    with pytest.raises(ValueError, match="micro-batches"):
        ours.rebalanced_shares(ranks + [n], n)


@pytest.mark.parametrize("shape", [(4, 4), (8, 8), (2, 4), (2, 2), (1, 2),
                                   (2, 16, 16)])
def test_surviving_domain_and_recovery_equal_reference(shape):
    tree, jtree = FractalTree(shape), JTree(shape)
    tiles = list(tree.tiles())
    rng = np.random.default_rng(len(tiles))
    for trial in range(12):
        k = int(rng.integers(0, len(tiles)))
        failed = [tiles[i] for i in rng.choice(len(tiles), size=k,
                                               replace=False)]
        assert F.surviving_domain(tree, failed) == \
            JF.surviving_domain(jtree, failed)
        plan = E.plan_recovery(tree, failed)
        jplan = JE.plan_recovery(jtree, failed)
        assert dataclasses.astuple(plan) == dataclasses.astuple(jplan)
        assert plan.world == jplan.world
        ranks = E.surviving_ranks(tree, plan.tiles)
        assert len(set(ranks)) == plan.world
        assert ranks == tuple(int(np.ravel_multi_index(t, shape))
                              for t in plan.tiles)
    with pytest.raises(RuntimeError):
        F.surviving_domain(tree, tiles)


@pytest.mark.parametrize("shape,failed,world,scale", [
    ((2, 4), [(1, 1)], 4, 2), ((4, 4), [(0, 0)], 8, 2),
    ((4, 4), [(0, 0), (3, 3)], 4, 4), ((2, 2), [(0, 1), (1, 0), (1, 1)], 1,
                                        4),
])
def test_plan_recovery_preserves_global_batch(shape, failed, world, scale):
    plan = E.plan_recovery(FractalTree(shape), failed)
    assert (plan.world, plan.grad_accum_scale) == (world, scale)
    assert plan.world * plan.grad_accum_scale == FractalTree(shape).num_tiles
    assert dataclasses.astuple(plan) == dataclasses.astuple(
        JE.plan_recovery(JTree(shape), failed))


# ---------------------------------------------------------------------------
# the loop's monitor, tracker and actuator (a host-only step function)
# ---------------------------------------------------------------------------


def _loop(step_fn, total_steps=6, **kw):
    data = SyntheticLM(get_config("qwen2.5-3b-smoke"),
                       DataConfig(global_batch=2, seq_len=8, seed=0))
    cfg_kw = {k: kw.pop(k) for k in ("rebalance_microbatches",) if k in kw}
    return TrainLoop(step_fn=step_fn, state=None, data=data,
                     cfg=LoopConfig(total_steps=total_steps, log_every=0,
                                    **cfg_kw), **kw)


def _per_rank(times):
    def step_fn(state, batch):
        return state, {"loss": np.float32(1.0),
                       "per_rank_step_s": np.array(times, np.float32)}
    return step_fn


def test_per_rank_metrics_feed_straggler_tracker():
    loop = _loop(_per_rank([0.1, 0.1, 0.1, 0.4]))
    loop.run()
    assert sorted(loop.stragglers.durations) == [0, 1, 2, 3]
    assert loop.stragglers.stragglers() == {3}
    shares = loop.stragglers.rebalanced_shares([0, 1, 2, 3], 8)
    assert sum(shares.values()) == 8
    assert shares[3] == min(shares.values()) < max(shares.values())


def test_rebalance_is_surfaced_and_actuated_on_change():
    calls = []

    def actuator(shares):
        calls.append(dict(shares))
        return _per_rank([0.1, 0.5]), (lambda b: dict(b, seen=True))

    loop = _loop(_per_rank([0.1, 0.5]), rebalance_microbatches=4,
                 rebalance_actuator=actuator)
    out = loop.run()
    hints = loop.rebalance_history
    assert hints and out["rebalance"] == hints
    assert hints[-1]["stragglers"] == [1]
    assert hints[-1]["shares"][1] < hints[-1]["shares"][0]
    assert len(calls) == 1 and calls[0] == hints[0]["shares"]
    assert all("loss" in h for h in loop.history)


def test_wall_clock_fallback_records_this_hosts_rank():
    loop = _loop(lambda s, b: (s, {"loss": 2.0}), total_steps=3,
                 host_rank=2)
    loop.run()
    assert list(loop.stragglers.durations) == [2]
    assert len(loop.stragglers.durations[2]) == 3


def test_failed_host_raises_worker_failure():
    clock = C.StepClock()
    mon = F.HostMonitor(num_hosts=3, timeout_s=2.0, clock=clock)
    for h in range(3):
        mon.heartbeat(h)

    def step_fn(state, batch):
        clock.tick()
        mon.heartbeat(0)
        mon.heartbeat(1)
        return state, {"loss": 1.0}

    loop = _loop(step_fn, total_steps=10, monitor=mon)
    with pytest.raises(WorkerFailure) as exc:
        loop.run()
    assert exc.value.failed_hosts == {2}
    assert [h["step"] for h in loop.history] == [0, 1]
