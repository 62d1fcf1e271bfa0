"""Fault-injected training soak: actuated rebalance + elastic recovery
(port of ``repro/runtime/soak.py``), on one device.

  1. **Straggler actuation.**  A ``runtime.chaos.FaultPlan`` ``slow``
     window inflates one rank's simulated superstep duration; the
     ``StragglerTracker`` flags it; the loop's ``rebalance_actuator``
     rebuilds the BSP step with UNEVEN per-rank micro-batch ``shares=``
     and swaps in the matching ``reshard_for_shares`` batch transform.
     Because the shares path is bit-consistent across partitions
     (compensated-pair accumulation — see ``trainer.make_bsp_train_step``),
     actuation changes WHO computes each micro-batch without perturbing
     the loss trajectory by a single bit.

  2. **Elastic recovery.**  A ``kill`` event silences one host's
     heartbeats on the virtual ``StepClock``; the ``HostMonitor`` times
     out; ``TrainLoop`` raises ``WorkerFailure``; the harness re-meshes
     onto the largest surviving complete fsync domain (``plan_recovery``;
     on one device the world's rank axis is cut, 8 → 4 at the default
     tree), restores the parameters from the latest checkpoint, and
     continues with even shares that PRESERVE the global micro-batch count
     (each survivor takes ``grad_accum_scale`` × the work).  Optimizer
     moments are ZeRO-1 sharded in a world-dependent flat layout, so
     cross-world restore would bind them to the wrong slices — they are
     re-initialized (recorded in the result), as in the reference.

``check_train_soak`` asserts the robustness claims: the rebalance
actually actuated (slow rank got the smallest share), the survivors form
a complete fsync subtree, the first replayed loss matches the pre-fault
recording at that step, and the loss keeps descending after recovery.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint.checkpointing import CheckpointManager
from repro_torch.core.bsp import BSPConfig
from repro_torch.core.tree import FractalTree
from repro_torch.data.pipeline import (DataConfig, SyntheticLM,
                                       reshard_for_shares)
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_config
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import trainer
from repro_torch.runtime.chaos import FaultPlan, StepClock
from repro_torch.runtime.elastic import plan_recovery, surviving_ranks
from repro_torch.runtime.fault_tolerance import HostMonitor, StragglerTracker
from repro_torch.runtime.loop import LoopConfig, TrainLoop, WorkerFailure


@dataclass(frozen=True)
class TrainSoakConfig:
    arch: str = "qwen2.5-3b-smoke"
    tree_shape: Tuple[int, ...] = (2, 4)    # hosts = prod(tree_shape)
    total_steps: int = 22
    microbatches: int = 16                  # global per step, preserved
    micro_rows: int = 1                     # rows per micro-batch
    seq_len: int = 16
    seed: int = 3
    lr: float = 1e-3
    checkpoint_every: int = 4
    hb_timeout_s: float = 3.0               # steps on the virtual clock
    straggler_window: int = 4
    straggler_threshold: float = 1.5
    # default plan: rank 3 runs 3× slow for steps [4, 10), rank 5 dies at
    # step 12 — exercises actuation THEN recovery in one run
    fault_spec: str = "slow:rank=3,factor=3.0,steps=4..10;kill:rank=5,step=12"
    base_step_s: float = 1.0                # simulated healthy superstep


@dataclass
class TrainSoakResult:
    history: List[Dict[str, Any]]           # pre-fault rows then replayed
    rebalance: List[Dict[str, Any]]
    actuated_shares: Optional[Dict[int, int]]
    recovery: Optional[Dict[str, Any]]      # level/tiles/worlds/step
    replay_pairs: List[Tuple[float, float]]  # (recorded, replayed) losses
    failures: List[str] = field(default_factory=list)
    # the port's instrumentation: every save (step, bytes, copy_s,
    # write_s) and the restore (bytes, seconds)
    saves: List[Dict[str, Any]] = field(default_factory=list)
    restore: Optional[Dict[str, Any]] = None

    @property
    def ok(self) -> bool:
        return not self.failures


class _ChaosStep:
    """Wraps the step: injects per-rank durations from the plan, ticks the
    virtual clock, emits heartbeats for every un-killed host (honoring
    drop/duplicate events).  ``inner`` is swapped in place by the
    rebalance actuator so the chaos envelope survives actuation."""

    def __init__(self, inner, plan: FaultPlan, clock: StepClock,
                 monitor: HostMonitor, world: int, base_s: float,
                 start_step: int = 0):
        self.inner = inner
        self.plan, self.clock, self.monitor = plan, clock, monitor
        self.world, self.base_s = world, base_s
        self.step = start_step

    def __call__(self, state, batch):
        state, metrics = self.inner(state, batch)
        s = self.step
        metrics = dict(metrics)
        metrics["per_rank_step_s"] = [
            self.base_s * self.plan.slow_factor(r, s)
            for r in range(self.world)]
        self.clock.tick()
        killed = self.plan.killed_by(s)
        for h in range(self.world):
            if h in killed or self.plan.heartbeat_dropped(h, s):
                continue
            self.monitor.heartbeat(h)
            if self.plan.heartbeat_duplicated(h, s):
                self.monitor.heartbeat(h)
        self.step += 1
        return state, metrics


def _even_shares(m_total: int, world: int) -> Tuple[int, ...]:
    if m_total % world:
        raise ValueError(f"{m_total} micro-batches do not split evenly "
                         f"over {world} ranks")
    return (m_total // world,) * world


def run_train_soak(scfg: TrainSoakConfig, checkpoint_dir: str,
                   device="cuda", cfg=None) -> TrainSoakResult:
    """One fault-injected training soak, the world's ranks stacked on
    ``device``.  ``cfg`` overrides ``scfg.arch``'s config (e.g. one cut in
    depth)."""
    dev = resolve_device(device)
    cfg = cfg or get_config(scfg.arch)
    tree = FractalTree(scfg.tree_shape)
    world = tree.num_tiles
    cols = scfg.tree_shape[-1]
    m_total = scfg.microbatches
    plan = FaultPlan.parse(scfg.fault_spec)
    clock = StepClock(step_s=1.0)
    monitor = HostMonitor(num_hosts=world, timeout_s=scfg.hb_timeout_s,
                          clock=clock)
    for h in range(world):
        monitor.heartbeat(h)

    acfg = AdamWConfig(lr=scfg.lr, warmup_steps=1,
                       total_steps=scfg.total_steps, grad_clip=0.0)
    bsp = BSPConfig(sync_axes=("data",), schedule="fractal")
    data = SyntheticLM(cfg, DataConfig(
        global_batch=m_total * scfg.micro_rows, seq_len=scfg.seq_len,
        seed=scfg.seed))

    def build(w, shares):
        return trainer.make_bsp_train_step(cfg, acfg, bsp, w, device=dev,
                                           shares=shares)

    shares0 = _even_shares(m_total, world)
    step_fn, init_state = build(world, shares0)
    state0 = init_state(T.init_params(cfg, 0, device=dev))

    chaos = _ChaosStep(step_fn, plan, clock, monitor, world,
                       scfg.base_step_s)
    result = TrainSoakResult(history=[], rebalance=[], actuated_shares=None,
                             recovery=None, replay_pairs=[])

    def actuator(shares_dict: Dict[int, int]):
        if sorted(shares_dict) != list(range(world)):
            return None
        shares = tuple(shares_dict[r] for r in range(world))
        chaos.inner, _ = build(world, shares)
        result.actuated_shares = dict(shares_dict)
        return chaos, (lambda b: reshard_for_shares(b, shares))

    loop = TrainLoop(
        step_fn=chaos, state=state0, data=data,
        cfg=LoopConfig(total_steps=scfg.total_steps,
                       checkpoint_every=scfg.checkpoint_every,
                       log_every=1, checkpoint_dir=checkpoint_dir,
                       rebalance_microbatches=m_total),
        monitor=monitor,
        stragglers=StragglerTracker(window=scfg.straggler_window,
                                    threshold=scfg.straggler_threshold),
        batch_transform=lambda b: reshard_for_shares(b, shares0),
        rebalance_actuator=actuator,
        ckpt_meta={"superstep_layout": init_state.superstep_layout})

    try:
        loop.run()
        result.failures.append(
            "fault plan injected no fatal failure: the soak never "
            "exercised recovery")
        result.history = loop.history
        return result
    except WorkerFailure as wf:
        failed_hosts = set(wf.failed_hosts)
    result.history = list(loop.history)
    result.rebalance = list(loop.rebalance_history)
    result.saves = list(loop.checkpoints.saves)

    # ---- elastic recovery on the surviving fsync domain ------------------
    failed_tiles = [divmod(h, cols) for h in sorted(failed_hosts)]
    eplan = plan_recovery(tree, failed_tiles, old_world=world)
    new_world = eplan.world
    ckpt = CheckpointManager(checkpoint_dir)
    t0 = time.perf_counter()
    restored = ckpt.restore(loop.state)
    restore_s = time.perf_counter() - t0
    # the pre-fault state (world-8 moments) is no longer needed
    loop.state = state0 = None
    if restored is None:
        result.failures.append("no checkpoint to restore from")
        return result
    old_state, meta = restored
    restore_step = int(meta["data_step"])
    result.restore = {"step": restore_step, "seconds": restore_s,
                      "bytes": (ckpt.dir / f"step_{meta['step']}.ckpt")
                      .stat().st_size}
    # even shares preserving the global micro-batch count: each survivor
    # takes grad_accum_scale × its old share
    shares2 = _even_shares(m_total, new_world)
    step_fn2, init_state2 = build(new_world, shares2)
    # params round-trip exactly; ZeRO-1 moments are world-layout-bound
    # (superstep_layout fingerprint differs) and restart from zero
    state2 = init_state2(old_state.params)
    del old_state
    state2.step = restore_step
    result.recovery = {
        "failed_hosts": sorted(failed_hosts), "level": eplan.level,
        "tiles": list(eplan.tiles),
        "ranks": list(surviving_ranks(tree, eplan.tiles)),
        "old_world": world, "new_world": new_world,
        "grad_accum_scale": eplan.grad_accum_scale,
        "restore_step": restore_step, "moments_reinitialized": True,
    }

    clock2 = StepClock(step_s=1.0)
    monitor2 = HostMonitor(num_hosts=new_world, timeout_s=scfg.hb_timeout_s,
                           clock=clock2)
    for h in range(new_world):
        monitor2.heartbeat(h)
    chaos2 = _ChaosStep(step_fn2, FaultPlan(), clock2, monitor2, new_world,
                        scfg.base_step_s, start_step=restore_step)
    loop2 = TrainLoop(
        step_fn=chaos2, state=state2, data=data,
        cfg=LoopConfig(total_steps=scfg.total_steps,
                       checkpoint_every=scfg.checkpoint_every,
                       log_every=1, checkpoint_dir=checkpoint_dir,
                       rebalance_microbatches=0),
        monitor=monitor2,
        start_step=restore_step,
        batch_transform=lambda b: reshard_for_shares(b, shares2),
        ckpt_meta={"superstep_layout": init_state2.superstep_layout})
    loop2.run()
    result.saves += loop2.checkpoints.saves

    recorded = {row["step"]: row["loss"] for row in result.history}
    for row in loop2.history:
        if row["step"] in recorded:
            result.replay_pairs.append((recorded[row["step"]], row["loss"]))
    result.history += loop2.history
    return result


def check_train_soak(result: TrainSoakResult,
                     scfg: TrainSoakConfig) -> TrainSoakResult:
    """Populate ``result.failures`` with every violated robustness claim."""
    plan = FaultPlan.parse(scfg.fault_spec)
    slow_ranks = {e.rank for e in plan.events if e.kind == "slow"}
    if slow_ranks:
        if result.actuated_shares is None:
            result.failures.append("straggler rebalance never actuated")
        else:
            sh = result.actuated_shares
            for r in slow_ranks:
                if sh[r] != min(sh.values()):
                    result.failures.append(
                        f"slow rank {r} got share {sh[r]}, not the "
                        f"minimum of {sh}")
            if len(set(sh.values())) == 1:
                result.failures.append(
                    f"actuated shares {sh} are still even — no rebalance")
    if result.recovery is None:
        result.failures.append("elastic recovery never ran")
    else:
        tree = FractalTree(scfg.tree_shape)
        rec = result.recovery
        domains = list(tree.domains(rec["level"]))
        if tuple(rec["tiles"]) not in [tuple(d) for d in domains]:
            result.failures.append(
                f"surviving tiles {rec['tiles']} are not a complete "
                f"level-{rec['level']} fsync domain")
        if rec["new_world"] * rec["grad_accum_scale"] != rec["old_world"]:
            result.failures.append(
                f"grad_accum_scale {rec['grad_accum_scale']} × new world "
                f"{rec['new_world']} != old world {rec['old_world']}: "
                "global batch not preserved")
        if not result.replay_pairs:
            result.failures.append(
                "no overlap between pre-fault history and replayed steps "
                "(checkpoint cadence vs detection latency)")
        for rec_l, rep_l in result.replay_pairs[:1]:
            # first replayed loss: computed from checkpoint-restored params
            # BEFORE any moment-dependent update → must match the pre-fault
            # recording (cross-world combine order shifts O(eps) at most)
            if not math.isclose(rec_l, rep_l, rel_tol=1e-5, abs_tol=1e-5):
                result.failures.append(
                    f"replayed loss {rep_l!r} at restore step diverged from "
                    f"pre-fault recording {rec_l!r}")
    losses = [row["loss"] for row in result.history]
    if len(losses) >= 6 and not (np.mean(losses[-3:]) < np.mean(losses[:3])):
        result.failures.append(
            f"loss did not descend across the soak: first {losses[:3]} "
            f"vs last {losses[-3:]}")
    return result
