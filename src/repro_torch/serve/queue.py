"""Request queue + synthetic arrival processes for the serve engine.

A ``Request`` is everything admission needs: prompt tokens, a per-request
generation budget, and an arrival time on the engine's step clock.  The
queue releases requests whose arrival time has passed — the engine polls it
once per step, so arrivals gate *admission*, never the decode loop.

Arrival generators:

  * ``poisson_arrivals(n, rate, seed)`` — exponential inter-arrival gaps
    (the classic open-loop load model), in seconds of engine clock;
  * ``burst_arrivals(n, rate, duty, period, seed)`` — on-off (bursty)
    traffic: Poisson at ``rate/duty`` during the first ``duty`` fraction
    of each period, silent for the rest — queue-depth spikes at a given
    long-run average rate (the soak harness's worst case);
  * ``trace_arrivals(spec)``           — explicit timestamps, either a
    comma-separated string ("0,0.5,0.5,2") or a file with one per line;
  * ``parse_arrival_spec("poisson:8", n, seed)`` — the CLI surface
    (immediate | poisson:RATE | burst:RATE,DUTY[,PERIOD] | trace:SPEC).
"""

from __future__ import annotations

import heapq
import os
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class Request:
    """One generation request.

    prompt          : token ids (host ints; the engine pads/chunks them)
    max_new_tokens  : generation budget, counting the first (prefill) token
    arrival_s       : arrival time on the engine clock (seconds)
    req_id          : unique id — also the RNG fold-in domain, so sampling
                      is deterministic per request regardless of which slot
                      or admission order serves it
    """

    req_id: int
    prompt: Sequence[int]
    max_new_tokens: int
    arrival_s: float = 0.0

    def __post_init__(self):
        if len(self.prompt) == 0:
            raise ValueError(f"request {self.req_id}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"request {self.req_id}: max_new_tokens must be >= 1")


@dataclass
class RequestQueue:
    """Arrival-ordered FIFO releasing requests whose time has come.

    A binary heap keyed ``(arrival_s, req_id)`` — the same total order the
    old sorted list kept (req_id is unique, so ``Request`` itself is never
    compared and ties stay deterministic), but submit and pop are O(log n)
    instead of the old ``list.pop(0)``'s O(n) shift, which went O(n²) per
    drain under heavy-traffic arrival bursts (preemption requeues included).
    """

    _heap: List[Tuple[float, int, Request]] = field(default_factory=list)

    def submit(self, requests) -> None:
        if isinstance(requests, Request):
            requests = [requests]
        for r in requests:
            heapq.heappush(self._heap, (r.arrival_s, r.req_id, r))

    def pop_ready(self, now_s: float) -> Optional[Request]:
        """Next request with arrival_s <= now_s, or None."""
        if self._heap and self._heap[0][0] <= now_s:
            return heapq.heappop(self._heap)[2]
        return None

    def next_arrival(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)


# ---------------------------------------------------------------------------
# arrival processes
# ---------------------------------------------------------------------------


def poisson_arrivals(n: int, rate_per_s: float, seed: int = 0
                     ) -> Tuple[float, ...]:
    """n arrival times with Exp(rate) inter-arrival gaps, starting at 0."""
    if rate_per_s <= 0:
        raise ValueError("poisson rate must be > 0")
    if n == 0:
        return ()
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_per_s, size=n)
    gaps[0] = 0.0                       # first request arrives immediately
    return tuple(np.cumsum(gaps).tolist())


def burst_arrivals(n: int, rate_per_s: float, duty: float,
                   period_s: float = 1.0, seed: int = 0
                   ) -> Tuple[float, ...]:
    """On-off bursty arrivals averaging ``rate_per_s`` requests/second.

    Each ``period_s`` window is "on" for its first ``duty`` fraction and
    silent for the rest; during the on-phase arrivals are Poisson at the
    peak rate ``rate_per_s / duty``, so the long-run average matches the
    equivalent Poisson load while the instantaneous rate spikes 1/duty×.
    Deterministic per (n, rate, duty, period, seed): a Poisson stream is
    drawn on the compressed "on-time" axis and mapped onto wall time by
    inserting the off-gaps.
    """
    if rate_per_s <= 0:
        raise ValueError("burst rate must be > 0")
    if not 0.0 < duty <= 1.0:
        raise ValueError(f"burst duty must be in (0,1], got {duty}")
    if period_s <= 0:
        raise ValueError("burst period must be > 0")
    if n == 0:
        return ()
    rng = np.random.default_rng(seed)
    peak = rate_per_s / duty
    gaps = rng.exponential(1.0 / peak, size=n)
    gaps[0] = 0.0                       # first request arrives immediately
    t_on = np.cumsum(gaps)              # time on the compressed on-axis
    on_len = duty * period_s
    k = np.floor(t_on / on_len)
    times = k * period_s + (t_on - k * on_len)
    return tuple(times.tolist())


def trace_arrivals(spec: str) -> Tuple[float, ...]:
    """Timestamps from a comma-separated string or a one-per-line file."""
    if os.path.exists(spec):
        with open(spec) as f:
            raw = [ln.strip() for ln in f if ln.strip()]
    else:
        raw = [tok.strip() for tok in spec.split(",") if tok.strip()]
    if not raw:
        raise ValueError(f"empty arrival trace {spec!r}")
    times = tuple(float(tok) for tok in raw)
    if any(b < a for a, b in zip(times, times[1:])):
        raise ValueError("arrival trace must be non-decreasing")
    return times


def parse_arrival_spec(spec: str, n: int, seed: int = 0) -> Tuple[float, ...]:
    """CLI arrival spec → n arrival times.

      "immediate"      every request present at t=0 (closed-loop batch)
      "poisson:RATE"   open-loop Poisson at RATE req/s
      "burst:RATE,DUTY[,PERIOD]"  on-off bursty traffic averaging RATE
                       req/s, on for DUTY of each PERIOD (default 1 s)
      "trace:SPEC"     explicit timestamps (string or file); must supply at
                       least n arrivals, truncated to the first n
    """
    if spec == "immediate":
        return (0.0,) * n
    if spec.startswith("poisson:"):
        return poisson_arrivals(n, float(spec.split(":", 1)[1]), seed)
    if spec.startswith("burst:"):
        parts = spec.split(":", 1)[1].split(",")
        if len(parts) not in (2, 3):
            raise ValueError(
                f"burst spec needs RATE,DUTY[,PERIOD], got {spec!r}")
        rate, duty = float(parts[0]), float(parts[1])
        period = float(parts[2]) if len(parts) == 3 else 1.0
        return burst_arrivals(n, rate, duty, period_s=period, seed=seed)
    if spec.startswith("trace:"):
        times = trace_arrivals(spec.split(":", 1)[1])
        if len(times) < n:
            raise ValueError(
                f"trace has {len(times)} arrivals for {n} requests")
        return times[:n]
    raise ValueError(f"unknown arrival spec {spec!r} "
                     "(immediate | poisson:RATE | burst:RATE,DUTY[,PERIOD] "
                     "| trace:SPEC)")
