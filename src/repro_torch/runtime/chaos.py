"""Deterministic fault injection for soak runs (serve AND train); a
pure-Python copy of ``repro/runtime/chaos.py``, so plans, specs and
queries are the reference's exactly.

A ``FaultPlan`` is a seedable, fully deterministic schedule of faults on
the virtual step clock, parsed from a compact spec string (the
``--fault-plan`` CLI surface) or generated randomly from a seed.  Both
loops consume the same plan object:

  * the TRAIN soak (``runtime/soak.py``) asks it which rank dies at which
    step (heartbeats stop → ``HostMonitor`` timeout → ``WorkerFailure``),
    which ranks run slow by what factor (fed into ``per_rank_step_s`` →
    ``StragglerTracker`` → actuated micro-batch rebalance), and which
    heartbeats to drop/duplicate;
  * the SERVE soak (``serve/soak.py`` in the reference; the port's comes
    with a later slice) asks it when admission stalls
    (``ServeEngine.hold_admission``) and when the block pool comes under
    external pressure (a fraction of blocks held hostage).

Spec grammar — ';'-separated events, each ``kind:key=value,...``:

  kill:rank=R,step=S            rank R's heartbeats stop at step S
  slow:rank=R,factor=F,steps=A..B   rank R runs F× slower for steps [A,B)
  drop_hb:host=H,steps=A..B     host H's heartbeats are lost in [A,B)
  dup_hb:host=H,step=S          host H heartbeats twice at step S
  stall:steps=A..B              serve admission stalls for steps [A,B)
  blocks:frac=F,steps=A..B      F of the KV block pool held in [A,B)

``StepClock`` is the train-side virtual clock: ``tick()`` advances one
virtual step, ``now()`` reads it — injected into ``HostMonitor`` so
heartbeat-timeout failure detection is deterministic in CI (no
``time.monotonic()`` anywhere in a soak run).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

KINDS = ("kill", "slow", "drop_hb", "dup_hb", "stall", "blocks")


@dataclass
class StepClock:
    """Virtual step clock: one ``tick()`` per superstep/engine step."""

    step_s: float = 1.0
    t: float = 0.0

    def tick(self, n: int = 1) -> None:
        self.t += n * self.step_s

    def now(self) -> float:
        return self.t

    # HostMonitor takes any zero-arg callable
    def __call__(self) -> float:
        return self.now()


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.  ``step``/``step_end`` bound the half-open
    window [step, step_end); point events have ``step_end == step + 1``."""

    kind: str
    step: int
    step_end: int
    rank: int = -1          # rank/host the event targets (-1: n/a)
    factor: float = 1.0     # slow: slowdown ×; blocks: pool fraction

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.step < 0 or self.step_end <= self.step:
            raise ValueError(
                f"{self.kind}: bad window [{self.step},{self.step_end})")
        if self.kind in ("kill", "slow", "drop_hb", "dup_hb") \
                and self.rank < 0:
            raise ValueError(f"{self.kind}: needs a rank/host")
        if self.kind == "slow" and self.factor <= 1.0:
            raise ValueError(f"slow: factor must be > 1, got {self.factor}")
        if self.kind == "blocks" and not 0.0 < self.factor <= 1.0:
            raise ValueError(f"blocks: frac must be in (0,1], "
                             f"got {self.factor}")

    def spec(self) -> str:
        """Round-trippable spec string for this event."""
        win = (f"steps={self.step}..{self.step_end}"
               if self.step_end != self.step + 1 else f"step={self.step}")
        if self.kind == "kill":
            return f"kill:rank={self.rank},step={self.step}"
        if self.kind == "slow":
            return (f"slow:rank={self.rank},factor={self.factor:g},"
                    f"steps={self.step}..{self.step_end}")
        if self.kind == "drop_hb":
            return f"drop_hb:host={self.rank},steps={self.step}.." \
                   f"{self.step_end}"
        if self.kind == "dup_hb":
            return f"dup_hb:host={self.rank},step={self.step}"
        if self.kind == "stall":
            return f"stall:steps={self.step}..{self.step_end}"
        return f"blocks:frac={self.factor:g},steps={self.step}.." \
               f"{self.step_end}"


def _parse_window(kv: Dict[str, str], kind: str) -> Tuple[int, int]:
    if "steps" in kv:
        a, _, b = kv["steps"].partition("..")
        if not b:
            raise ValueError(f"{kind}: steps needs A..B, got {kv['steps']!r}")
        return int(a), int(b)
    if "step" in kv:
        s = int(kv["step"])
        return s, s + 1
    raise ValueError(f"{kind}: needs step=S or steps=A..B")


@dataclass(frozen=True)
class FaultPlan:
    """An immutable, queryable schedule of fault events."""

    events: Tuple[FaultEvent, ...] = ()

    # -- construction -----------------------------------------------------
    @staticmethod
    def parse(spec: str) -> "FaultPlan":
        """Parse ';'-separated event specs (empty string → empty plan)."""
        events: List[FaultEvent] = []
        for raw in spec.split(";"):
            raw = raw.strip()
            if not raw:
                continue
            kind, _, body = raw.partition(":")
            kind = kind.strip()
            if kind not in KINDS:
                raise ValueError(f"unknown fault kind {kind!r} in {raw!r} "
                                 f"(one of {', '.join(KINDS)})")
            kv: Dict[str, str] = {}
            for item in body.split(","):
                item = item.strip()
                if not item:
                    continue
                k, eq, v = item.partition("=")
                if not eq:
                    raise ValueError(f"{raw!r}: expected key=value, "
                                     f"got {item!r}")
                kv[k.strip()] = v.strip()
            step, step_end = _parse_window(kv, kind)
            rank = int(kv.get("rank", kv.get("host", -1)))
            factor = float(kv.get("factor", kv.get("frac", 1.0)))
            events.append(FaultEvent(kind=kind, step=step, step_end=step_end,
                                     rank=rank, factor=factor))
        return FaultPlan(tuple(events))

    @staticmethod
    def random(seed: int, steps: int, ranks: int,
               n_events: int = 3) -> "FaultPlan":
        """A seedable random plan: same (seed, steps, ranks) → same plan.
        Draws slow/stall/blocks windows plus at most one kill, all inside
        [steps//4, 3·steps//4) so the soak keeps pre-fault baseline and
        post-fault recovery room."""
        rng = np.random.default_rng(seed)
        lo, hi = max(1, steps // 4), max(2, 3 * steps // 4)
        events: List[FaultEvent] = []
        kinds = ["slow", "stall", "blocks", "kill"]
        for i in range(n_events):
            kind = kinds[int(rng.integers(0, len(kinds)))] if i else "slow"
            a = int(rng.integers(lo, hi))
            b = min(hi, a + int(rng.integers(2, max(3, steps // 8))))
            if kind == "kill":
                events.append(FaultEvent("kill", a, a + 1,
                                         rank=int(rng.integers(0, ranks))))
            elif kind == "slow":
                events.append(FaultEvent(
                    "slow", a, b, rank=int(rng.integers(0, ranks)),
                    factor=float(1.5 + 2.0 * rng.random())))
            elif kind == "stall":
                events.append(FaultEvent("stall", a, b))
            else:
                events.append(FaultEvent(
                    "blocks", a, b,
                    factor=float(0.25 + 0.5 * rng.random())))
        return FaultPlan(tuple(events))

    def spec(self) -> str:
        return ";".join(e.spec() for e in self.events)

    # -- train-side queries -----------------------------------------------
    def kills_at(self, step: int) -> Set[int]:
        return {e.rank for e in self.events
                if e.kind == "kill" and e.step == step}

    def killed_by(self, step: int) -> Set[int]:
        """Ranks whose kill step is ≤ ``step`` (dead from then on)."""
        return {e.rank for e in self.events
                if e.kind == "kill" and e.step <= step}

    def slow_factor(self, rank: int, step: int) -> float:
        f = 1.0
        for e in self.events:
            if e.kind == "slow" and e.rank == rank \
                    and e.step <= step < e.step_end:
                f = max(f, e.factor)
        return f

    def heartbeat_dropped(self, host: int, step: int) -> bool:
        return any(e.kind == "drop_hb" and e.rank == host
                   and e.step <= step < e.step_end for e in self.events)

    def heartbeat_duplicated(self, host: int, step: int) -> bool:
        return any(e.kind == "dup_hb" and e.rank == host
                   and e.step <= step < e.step_end for e in self.events)

    # -- serve-side queries -----------------------------------------------
    def admission_stalled(self, step: int) -> bool:
        return any(e.kind == "stall" and e.step <= step < e.step_end
                   for e in self.events)

    def block_pressure(self, step: int) -> float:
        """Fraction of the block pool under external pressure at ``step``
        (0.0 when no ``blocks`` window covers it)."""
        f = 0.0
        for e in self.events:
            if e.kind == "blocks" and e.step <= step < e.step_end:
                f = max(f, e.factor)
        return f

    # -- window accounting (SLO recovery asserts on these) ----------------
    def fault_windows(self) -> Tuple[Tuple[int, int], ...]:
        return tuple(sorted((e.step, e.step_end) for e in self.events))

    def first_fault_start(self) -> Optional[int]:
        return min((e.step for e in self.events), default=None)

    def last_fault_end(self) -> Optional[int]:
        return max((e.step_end for e in self.events), default=None)

    def __bool__(self) -> bool:
        return bool(self.events)
