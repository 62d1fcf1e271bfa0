"""Fault tolerance + straggler mitigation for BSP training; a pure-Python
port of ``repro/runtime/fault_tolerance.py`` over the port's own
``core/tree.FractalTree``, so its answers are the reference's exactly.

BSP's weakness at scale is that the barrier waits for the slowest rank; the
paper makes the barrier itself ~free, which moves the problem to (a) dead
hosts and (b) stragglers.  This module provides the control-plane pieces,
exercised in tests and by the train soak (``runtime/soak.py``):

  * ``HostMonitor``    — heartbeat registry with timeout-based failure
    detection (the NoC-level 'error' wire analogue at cluster scope).
  * ``StragglerTracker`` — per-rank superstep durations; flags ranks slower
    than ``threshold × median`` over a window and computes a proportional
    micro-batch rebalance (gradient contributions stay weighted-correct).
  * ``surviving_domain`` — the FractalSync-native recovery policy: after
    failures, find the LARGEST complete synchronization subtree (fsync
    level/domain) containing no failed leaf; training resumes scoped to that
    domain while replacements spin up.  This is the paper's programmable
    sync-domain feature doing elastic scaling.
"""

from __future__ import annotations

import statistics
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import (Callable, Dict, Iterable, Optional, Sequence, Set,
                    Tuple)

from repro_torch.core.tree import FractalTree

Coord = Tuple[int, ...]


@dataclass
class HostMonitor:
    """Heartbeat registry with timeout-based failure detection.

    ``clock`` injects the time source: None → wall clock
    (``time.monotonic``), or any zero-arg callable — e.g. the virtual
    ``runtime.chaos.StepClock`` — so soak runs detect heartbeat timeouts
    deterministically on the step clock.  An explicit ``now=`` argument
    always wins (the existing test surface).
    """

    num_hosts: int
    timeout_s: float = 30.0
    last_seen: Dict[int, float] = field(default_factory=dict)
    clock: Optional[Callable[[], float]] = None

    def _now(self, now: Optional[float]) -> float:
        if now is not None:
            return now
        return self.clock() if self.clock is not None else time.monotonic()

    def heartbeat(self, host: int, now: Optional[float] = None) -> None:
        if not 0 <= host < self.num_hosts:
            raise ValueError(f"host {host} outside 0..{self.num_hosts - 1}")
        self.last_seen[host] = self._now(now)

    def failed_hosts(self, now: Optional[float] = None) -> Set[int]:
        now = self._now(now)
        out = set()
        for h in range(self.num_hosts):
            seen = self.last_seen.get(h)
            if seen is None or now - seen > self.timeout_s:
                out.add(h)
        return out

    def healthy(self, now: Optional[float] = None) -> bool:
        return not self.failed_hosts(now)


@dataclass
class StragglerTracker:
    window: int = 16
    threshold: float = 1.5
    durations: Dict[int, deque] = field(
        default_factory=lambda: defaultdict(lambda: deque(maxlen=16)))

    def record(self, rank: int, superstep_s: float) -> None:
        d = self.durations[rank]
        if d.maxlen != self.window:
            d = deque(d, maxlen=self.window)
            self.durations[rank] = d
        d.append(superstep_s)

    def rank_speed(self, rank: int) -> Optional[float]:
        d = self.durations.get(rank)
        return statistics.median(d) if d else None

    def stragglers(self) -> Set[int]:
        speeds = {r: statistics.median(d)
                  for r, d in self.durations.items() if d}
        if len(speeds) < 2:
            return set()
        med = statistics.median(speeds.values())
        return {r for r, s in speeds.items() if s > self.threshold * med}

    def rebalanced_shares(self, ranks: Sequence[int],
                          total_microbatches: int) -> Dict[int, int]:
        """Micro-batches ∝ 1/median-duration, ≥1 each, summing to total.

        In BSP the superstep ends at max(rank time); giving slow ranks fewer
        micro-batches flattens the barrier-arrival distribution — the same
        Ŝ = max(F) − max(R) metric the paper optimizes, attacked from the
        arrival side.

        Every share is ≥ 1 (a rank with zero micro-batches would
        desynchronize the collective), so the rebalance needs at least one
        micro-batch per rank — fewer raises instead of spinning forever in
        the drift-correction loop (every share would already be clamped at
        1 with the sum still above the target).
        """
        if not ranks:
            raise ValueError("rebalanced_shares needs at least one rank")
        if total_microbatches < len(ranks):
            raise ValueError(
                f"cannot split {total_microbatches} micro-batches over "
                f"{len(ranks)} ranks: every rank needs >= 1 (raise the "
                "micro-batch count or shrink the sync domain)")
        speeds = {}
        for r in ranks:
            m = self.rank_speed(r)
            speeds[r] = 1.0 / m if m else 1.0
        total_speed = sum(speeds.values())
        shares = {r: max(1, int(round(total_microbatches * s / total_speed)))
                  for r, s in speeds.items()}
        # Fix rounding drift deterministically, preserving monotonicity in
        # measured speed: excess comes off the SLOWEST ranks first (their
        # shares can only move toward the faster ranks'), shortfall goes to
        # the FASTEST first.  Ties break by rank id.
        fastest_first = sorted(ranks, key=lambda r: (-speeds[r], r))
        slowest_first = list(reversed(fastest_first))
        i = 0
        while sum(shares.values()) > total_microbatches:
            r = slowest_first[i % len(slowest_first)]
            if shares[r] > 1:
                shares[r] -= 1
            i += 1
        i = 0
        while sum(shares.values()) < total_microbatches:
            shares[fastest_first[i % len(fastest_first)]] += 1
            i += 1
        return shares


def surviving_domain(tree: FractalTree, failed: Iterable[Coord]
                     ) -> Tuple[int, Tuple[Coord, ...]]:
    """Largest complete sync subtree (fsync level + member tiles) avoiding
    every failed leaf.  Returns (level, tiles); level 0 = a single tile."""
    failed = set(failed)
    alive = [t for t in tree.tiles() if t not in failed]
    if not alive:
        raise RuntimeError("no surviving tiles")
    best: Tuple[int, Tuple[Coord, ...]] = (0, (alive[0],))
    for level in range(tree.num_levels, 0, -1):
        for domain in tree.domains(level):
            if not failed.intersection(domain):
                return level, domain
    return best
