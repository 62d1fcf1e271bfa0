"""Sustained-load soak + SLO harness for the serve engine (port of
``repro/serve/soak.py``, on the port's ``runtime.chaos.FaultPlan``).

This module answers the production question: under hours of open-loop
traffic, with faults injected, does p99 TTFT stay inside the SLO band,
and how fast does it RECOVER once a fault window closes?

``run_soak`` drives a ``ServeEngine`` for thousands of virtual-clock
steps under any arrival process (Poisson / bursty / trace), submitting
requests only when their arrival time passes (so ``len(engine.queue)``
is the true backlog), applying a ``runtime.chaos.FaultPlan`` each step:

  * ``stall`` windows hold admission (``engine.hold_admission``) — the
    backlog and TTFT grow while live decodes keep streaming;
  * ``blocks`` windows confiscate a fraction of the paged KV pool (held
    via the engine's own allocator, released when the window closes) —
    admission defers and the youngest decodes get preempted, exactly the
    pressure path the paged backend is built to absorb.

Every ``window`` steps it snapshots a trend row (windowed p50/p99 TTFT
from the metrics event log, queue depth, preemption/prefix-hit deltas,
blocks in use); streaming P² estimators run alongside for the long-run
view.  ``check_recovery`` then asserts the SLO claim: windowed p99 TTFT
returns to ``baseline × recovery_band`` within ``recovery_steps`` after
the last fault window closes (baseline = steady-state p99 measured after
warmup, before the first fault).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from repro_torch.runtime.chaos import FaultPlan

from .blocks import NoFreeBlocks
from .engine import ServeEngine
from .queue import Request


@dataclass(frozen=True)
class SoakConfig:
    steps: int = 2000            # virtual-clock engine steps to drive
    window: int = 50             # trend-row cadence (steps)
    warmup_steps: int = 100      # excluded from the baseline measurement
    recovery_band: float = 1.5   # p99 must return within band × baseline
    recovery_slack_s: float = 0.0   # absolute slack added to the band
    recovery_steps: int = 500    # ... within this many steps of fault end
    slo_p99_s: Optional[float] = None   # absolute steady-state SLO (opt.)


@dataclass
class SoakResult:
    summary: Dict[str, float]
    trend: List[Dict[str, float]]
    baseline_p99_s: float
    fault_end_step: Optional[int]
    recovered_step: Optional[int]     # first healthy window end after fault
    failures: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.failures

    @property
    def recovery_steps_taken(self) -> Optional[int]:
        if self.recovered_step is None or self.fault_end_step is None:
            return None
        return self.recovered_step - self.fault_end_step


def _p_of(xs: List[float], q: float) -> float:
    if not xs:
        return float("nan")
    xs = sorted(xs)
    i = min(len(xs) - 1, int(round(q * (len(xs) - 1))))
    return xs[i]


def _soak_step(engine: ServeEngine, s: int, pending: List[Request],
               plan: FaultPlan, held_blocks: List[int]) -> None:
    """Step ``s`` of a soak: submit what has arrived, apply ``plan``'s
    faults (an admission stall; the paged pool's confiscated share, held
    in ``held_blocks`` through the engine's own allocator), one engine
    step."""
    now = engine.metrics.now()
    while pending and pending[-1].arrival_s <= now:
        engine.submit(pending.pop())
    if plan.admission_stalled(s):
        engine.hold_admission(1)
    if engine.allocator is not None:
        target = int(plan.block_pressure(s) * engine.allocator.capacity)
        while len(held_blocks) < target:
            try:
                held_blocks.append(engine.allocator.alloc())
            except NoFreeBlocks:
                break                   # pool already drained: maximal
        if len(held_blocks) > target:
            engine.allocator.free_blocks(held_blocks[target:])
            del held_blocks[target:]
        engine._record_blocks()
    engine.step()


def run_soak(engine: ServeEngine, requests: Sequence[Request],
             plan: Optional[FaultPlan] = None,
             scfg: SoakConfig = SoakConfig()) -> SoakResult:
    """Drive ``engine`` for ``scfg.steps`` steps under ``requests`` with
    ``plan``'s faults injected; returns trends + recovery verdict."""
    plan = plan or FaultPlan()
    m = engine.metrics
    if m.clock != "step":
        raise ValueError("soak runs need the virtual step clock "
                         "(EngineConfig.clock='step'): recovery windows "
                         "are counted in deterministic steps")
    m.record_events = True
    pending = sorted(requests, key=lambda r: (r.arrival_s, r.req_id))
    pending.reverse()                       # pop() from the earliest end

    held_blocks: List[int] = []
    trend: List[Dict[str, float]] = []
    ev_ptr = 0                              # consumed ttft_events
    win_queue_max = 0
    win_preempt0 = win_tokens0 = 0
    m.start()

    for s in range(scfg.steps):
        _soak_step(engine, s, pending, plan, held_blocks)
        win_queue_max = max(win_queue_max, len(engine.queue))

        # -- trend row every `window` steps -------------------------------
        if (s + 1) % scfg.window == 0 or s + 1 == scfg.steps:
            ttfts = [t for _, t in m.ttft_events[ev_ptr:]]
            ev_ptr = len(m.ttft_events)
            trend.append({
                "step": s + 1,
                "ttft_p50_s": _p_of(ttfts, 0.50),
                "ttft_p99_s": _p_of(ttfts, 0.99),
                "first_tokens": len(ttfts),
                "queue_depth": len(engine.queue),
                "queue_max": win_queue_max,
                "active": len(engine.table.busy()),
                "preemptions": m.preemptions - win_preempt0,
                "tokens_out": m.tokens_out - win_tokens0,
                "prefix_hit_rate": m.prefix_hit_rate,
                "blocks_in_use": m.blocks_in_use,
                "blocks_held": len(held_blocks),
            })
            win_queue_max = 0
            win_preempt0, win_tokens0 = m.preemptions, m.tokens_out

    if held_blocks:                         # plan ended mid-window
        engine.allocator.free_blocks(held_blocks)
        held_blocks.clear()
        engine._record_blocks()
    m.stop()

    # -- baseline + recovery ----------------------------------------------
    first_fault = plan.first_fault_start()
    fault_end = plan.last_fault_end()
    t_warm = scfg.warmup_steps * m.step_s
    t_fault = (first_fault * m.step_s) if first_fault is not None \
        else float("inf")
    baseline = [t for at, t in m.ttft_events if t_warm <= at < t_fault]
    baseline_p99 = _p_of(baseline, 0.99)

    recovered = None
    if fault_end is not None:
        bound = baseline_p99 * scfg.recovery_band + scfg.recovery_slack_s
        for row in trend:
            if row["step"] <= fault_end:
                continue
            healthy_quiet = (row["first_tokens"] == 0
                             and row["queue_depth"] == 0)
            if healthy_quiet or (row["first_tokens"] > 0
                                 and row["ttft_p99_s"] <= bound):
                recovered = row["step"]
                break

    result = SoakResult(summary=m.summary(), trend=trend,
                        baseline_p99_s=baseline_p99,
                        fault_end_step=fault_end, recovered_step=recovered)
    check_recovery(result, scfg)
    return result


def check_recovery(result: SoakResult, scfg: SoakConfig) -> None:
    """Populate ``result.failures`` with every violated SLO claim."""
    if result.fault_end_step is not None:
        if result.recovered_step is None:
            result.failures.append(
                f"p99 TTFT never returned to {scfg.recovery_band}× the "
                f"pre-fault baseline ({result.baseline_p99_s * 1e3:.1f} ms) "
                f"after the fault window closed at step "
                f"{result.fault_end_step}")
        elif result.recovery_steps_taken > scfg.recovery_steps:
            result.failures.append(
                f"p99 TTFT took {result.recovery_steps_taken} steps to "
                f"recover (bound: {scfg.recovery_steps}) after step "
                f"{result.fault_end_step}")
    if scfg.slo_p99_s is not None:
        base = result.baseline_p99_s
        if not base <= scfg.slo_p99_s:      # NaN baseline also fails
            result.failures.append(
                f"steady-state p99 TTFT {base * 1e3:.1f} ms violates the "
                f"{scfg.slo_p99_s * 1e3:.1f} ms SLO")
