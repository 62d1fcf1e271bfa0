"""Serving metrics: per-request TTFT, per-step throughput, slot occupancy.

Two clocks run side by side:

  * the **step counters** — deterministic tallies (decode steps, tokens
    out, active-slot sums) that benchmarks and CI assert on;
  * the **serve clock** behind ``now()`` — either measured wall seconds
    (``clock="wall"``: human-facing tok/s and TTFT, noisy on shared CI
    machines, never asserted) or a VIRTUAL step clock (``clock="step"``,
    the engine default): time advances ``step_s`` per engine step via
    ``tick()`` and jumps forward via ``wait_until()`` instead of sleeping
    — deterministic TTFTs, and serve loops never block on arrival gaps.

``occupancy`` is the serve engine's headline number: the fraction of
slot-steps that decoded a live request.  The wave baseline burns slot-steps
on padding until the longest request in the wave drains; continuous
admission refills slots the moment EOS frees them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


class P2Quantile:
    """Jain & Chlamtac's P² streaming quantile estimator: O(1) memory,
    one pass — the soak harness runs for thousands of steps and cannot
    afford (nor needs) to sort the full latency history.  Exact below 5
    observations, piecewise-parabolic marker interpolation after.
    """

    def __init__(self, q: float):
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0,1), got {q}")
        self.q = q
        self.n = 0
        self._heights: List[float] = []          # 5 marker heights
        self._pos: List[float] = []              # marker positions (1-based)
        self._want: List[float] = []             # desired positions
        self._inc = (0.0, q / 2, q, (1 + q) / 2, 1.0)

    def add(self, x: float) -> None:
        self.n += 1
        if self.n <= 5:
            self._heights.append(float(x))
            self._heights.sort()
            if self.n == 5:
                self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]
                self._want = [1.0, 1 + 2 * self.q, 1 + 4 * self.q,
                              3 + 2 * self.q, 5.0]
            return
        h, pos = self._heights, self._pos
        if x < h[0]:
            h[0] = float(x)
            k = 0
        elif x >= h[4]:
            h[4] = float(x)
            k = 3
        else:
            k = 0
            while x >= h[k + 1]:
                k += 1
        for i in range(k + 1, 5):
            pos[i] += 1.0
        for i in range(5):
            self._want[i] += self._inc[i]
        for i in (1, 2, 3):
            d = self._want[i] - pos[i]
            if (d >= 1 and pos[i + 1] - pos[i] > 1) or \
                    (d <= -1 and pos[i - 1] - pos[i] < -1):
                d = 1.0 if d > 0 else -1.0
                # parabolic (P²) update, clamped to stay monotone
                hp = h[i] + d / (pos[i + 1] - pos[i - 1]) * (
                    (pos[i] - pos[i - 1] + d) * (h[i + 1] - h[i])
                    / (pos[i + 1] - pos[i])
                    + (pos[i + 1] - pos[i] - d) * (h[i] - h[i - 1])
                    / (pos[i] - pos[i - 1]))
                if not h[i - 1] < hp < h[i + 1]:
                    hp = h[i] + d * (h[i + int(d)] - h[i]) \
                        / (pos[i + int(d)] - pos[i])
                h[i] = hp
                pos[i] += d

    @property
    def value(self) -> float:
        if self.n == 0:
            return float("nan")
        if self.n <= 5:
            xs = self._heights
            i = min(len(xs) - 1, int(round(self.q * (len(xs) - 1))))
            return xs[i]
        return self._heights[2]


@dataclass
class RequestRecord:
    req_id: int
    arrival_s: float = 0.0
    admitted_s: Optional[float] = None
    first_token_s: Optional[float] = None
    finished_s: Optional[float] = None
    prompt_len: int = 0
    tokens_out: int = 0

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.arrival_s


@dataclass
class ServeMetrics:
    max_slots: int = 1
    requests: Dict[int, RequestRecord] = field(default_factory=dict)
    decode_steps: int = 0
    active_slot_steps: int = 0       # Σ over decode steps of live slots
    decode_tokens: int = 0           # tokens produced by decode steps
    prefill_chunks: int = 0
    prefill_tokens: int = 0
    peak_active: int = 0             # max live slots in any decode step
    # paged-KV gauges (stay 0 for the contiguous backend):
    prefix_hit_tokens: int = 0       # prompt tokens served from shared blocks
    prefix_lookup_tokens: int = 0    # prompt tokens that went through lookup
    blocks_in_use: int = 0           # current allocated blocks
    blocks_peak: int = 0             # high-water mark
    blocks_total: int = 0            # pool capacity (sentinel excluded)
    preemptions: int = 0             # preempt-and-requeue events
    wasted_decode_tokens: int = 0    # decode tokens discarded by preemption
    queue_depth: int = 0             # admission backlog (gauge, per step)
    queue_peak: int = 0              # backlog high-water mark
    # event logs for windowed trend analysis (the soak harness turns them
    # on; OFF by default so long-lived engines pay nothing):
    record_events: bool = False
    ttft_events: List[Tuple[float, float]] = field(default_factory=list)
    tpot_events: List[Tuple[float, float]] = field(default_factory=list)
    clock: str = "wall"              # "wall" (measured) | "step" (virtual)
    step_s: float = 0.01             # virtual seconds per engine step
    _t0: Optional[float] = None
    _vt: float = 0.0                 # virtual clock position (step mode)
    wall_s: float = 0.0
    # streaming percentile estimators (P², O(1) memory): always on — a
    # preempted-and-reserved request contributes BOTH its ttft samples
    # (the stream sees what clients saw; the per-request record keeps
    # only the final one)
    p2_ttft_p50: P2Quantile = field(default_factory=lambda: P2Quantile(0.5))
    p2_ttft_p99: P2Quantile = field(default_factory=lambda: P2Quantile(0.99))
    p2_tpot_p99: P2Quantile = field(default_factory=lambda: P2Quantile(0.99))

    # -- clock ------------------------------------------------------------
    def start(self) -> None:
        self._t0 = time.monotonic()

    def now(self) -> float:
        if self.clock == "step":
            return self._vt
        if self._t0 is None:
            self.start()
        return time.monotonic() - self._t0

    def tick(self) -> None:
        """One engine step elapsed (virtual clock; wall mode is a no-op —
        real time passed on its own)."""
        if self.clock == "step":
            self._vt += self.step_s

    def wait_until(self, t: float) -> None:
        """Idle until the serve clock reaches ``t``: the virtual clock
        jumps (deterministic, instant), the wall clock sleeps."""
        if self.clock == "step":
            self._vt = max(self._vt, t)
            return
        now = self.now()
        if t > now:
            time.sleep(t - now)

    def stop(self) -> None:
        self.wall_s = self.now()

    # -- events -----------------------------------------------------------
    def on_submit(self, req_id: int, arrival_s: float, prompt_len: int) -> None:
        self.requests[req_id] = RequestRecord(
            req_id=req_id, arrival_s=arrival_s, prompt_len=prompt_len)

    def on_admit(self, req_id: int) -> None:
        self.requests[req_id].admitted_s = self.now()

    def on_prefill_chunk(self, n_tokens: int) -> None:
        self.prefill_chunks += 1
        self.prefill_tokens += n_tokens

    def on_first_token(self, req_id: int) -> None:
        r = self.requests[req_id]
        r.first_token_s = self.now()
        r.tokens_out += 1
        ttft = r.first_token_s - r.arrival_s
        self.p2_ttft_p50.add(ttft)
        self.p2_ttft_p99.add(ttft)
        if self.record_events:
            self.ttft_events.append((r.first_token_s, ttft))

    def on_decode_step(self, n_active: int) -> None:
        self.decode_steps += 1
        self.active_slot_steps += n_active
        self.decode_tokens += n_active
        self.peak_active = max(self.peak_active, n_active)

    def on_token(self, req_id: int) -> None:
        self.requests[req_id].tokens_out += 1

    def on_finish(self, req_id: int) -> None:
        r = self.requests[req_id]
        r.finished_s = self.now()
        if r.first_token_s is not None and r.tokens_out > 1:
            tpot = (r.finished_s - r.first_token_s) / (r.tokens_out - 1)
            self.p2_tpot_p99.add(tpot)
            if self.record_events:
                self.tpot_events.append((r.finished_s, tpot))

    def on_queue_depth(self, depth: int) -> None:
        """Admission-backlog gauge, sampled once per engine step."""
        self.queue_depth = depth
        self.queue_peak = max(self.queue_peak, depth)

    def on_prefix_lookup(self, hit_tokens: int, total_tokens: int) -> None:
        """One admission's prefix-cache outcome: ``hit_tokens`` of the
        ``total_tokens``-long prompt were served from shared blocks."""
        self.prefix_hit_tokens += hit_tokens
        self.prefix_lookup_tokens += total_tokens

    def on_blocks(self, in_use: int, total: int) -> None:
        """Block-pool gauge sample (paged backend)."""
        self.blocks_in_use = in_use
        self.blocks_peak = max(self.blocks_peak, in_use)
        self.blocks_total = total

    def on_preempt(self, req_id: int) -> None:
        """A mid-flight request lost its resources and went back to the
        queue: its per-request record restarts (tokens regenerate exactly
        on re-serve — the fold-in RNG makes the retry invisible in
        outputs).  The discarded work is BOOKED, not erased: of the
        request's ``tokens_out``, all but the first (which came from the
        prefill logits) were produced by decode steps whose
        ``decode_tokens`` tally keeps counting them — they land in
        ``wasted_decode_tokens`` so throughput accounting stays exact:
        ``decode_tokens == (tokens_out - first_tokens) + wasted``."""
        self.preemptions += 1
        r = self.requests[req_id]
        if r.first_token_s is not None and r.tokens_out > 0:
            self.wasted_decode_tokens += r.tokens_out - 1
        r.admitted_s = None
        r.first_token_s = None
        r.finished_s = None
        r.tokens_out = 0

    # -- aggregates -------------------------------------------------------
    @property
    def tokens_out(self) -> int:
        return sum(r.tokens_out for r in self.requests.values())

    @property
    def first_tokens(self) -> int:
        """Requests whose (current) first token is live — first tokens come
        from prefill logits, so they are excluded from decode accounting."""
        return sum(1 for r in self.requests.values()
                   if r.first_token_s is not None)

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of looked-up prompt tokens served from shared blocks."""
        if self.prefix_lookup_tokens == 0:
            return 0.0
        return self.prefix_hit_tokens / self.prefix_lookup_tokens

    @property
    def occupancy(self) -> float:
        """Fraction of decode slot-steps spent on live requests."""
        if self.decode_steps == 0:
            return 0.0
        return self.active_slot_steps / (self.decode_steps * self.max_slots)

    @property
    def tokens_per_step(self) -> float:
        """Decode tokens per decode step — the deterministic throughput
        proxy: per-step cost is shape-constant, so tok/s ∝ tokens/step."""
        if self.decode_steps == 0:
            return 0.0
        return self.decode_tokens / self.decode_steps

    def ttfts(self) -> List[float]:
        return sorted(r.ttft_s for r in self.requests.values()
                      if r.ttft_s is not None)

    def _pct(self, xs: List[float], q: float) -> float:
        if not xs:
            return float("nan")
        i = min(len(xs) - 1, int(round(q * (len(xs) - 1))))
        return xs[i]

    def summary(self) -> Dict[str, float]:
        ttfts = self.ttfts()
        wall = self.wall_s or self.now()
        return {
            "requests": len(self.requests),
            "completed": sum(1 for r in self.requests.values()
                             if r.finished_s is not None),
            "tokens_out": self.tokens_out,
            "decode_steps": self.decode_steps,
            "tokens_per_step": self.tokens_per_step,
            "occupancy": self.occupancy,
            "peak_active": self.peak_active,
            "prefill_chunks": self.prefill_chunks,
            "prefill_tokens": self.prefill_tokens,
            "prefix_hit_rate": self.prefix_hit_rate,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "blocks_in_use": self.blocks_in_use,
            "blocks_peak": self.blocks_peak,
            "blocks_total": self.blocks_total,
            "preemptions": self.preemptions,
            "wasted_decode_tokens": self.wasted_decode_tokens,
            "first_tokens": self.first_tokens,
            "queue_peak": self.queue_peak,
            "ttft_mean_s": (sum(ttfts) / len(ttfts)) if ttfts else float("nan"),
            "ttft_p50_s": self._pct(ttfts, 0.50),
            "ttft_p95_s": self._pct(ttfts, 0.95),
            "ttft_p99_s": self._pct(ttfts, 0.99),
            # streaming (P²) views — what a week-long soak reports when the
            # per-request table is long gone
            "ttft_p50_stream_s": self.p2_ttft_p50.value,
            "ttft_p99_stream_s": self.p2_ttft_p99.value,
            "tpot_p99_stream_s": self.p2_tpot_p99.value,
            "wall_s": wall,
            "tokens_per_s": self.tokens_out / wall if wall > 0 else 0.0,
        }

    def report(self) -> str:
        s = self.summary()
        lines = [
            f"requests : {s['completed']:.0f}/{s['requests']:.0f} completed, "
            f"{s['tokens_out']:.0f} tokens out",
            f"decode   : {s['decode_steps']:.0f} steps, "
            f"{s['tokens_per_step']:.2f} tok/step, "
            f"occupancy {s['occupancy'] * 100:.1f}%, "
            f"peak {s['peak_active']:.0f} slots",
            f"prefill  : {s['prefill_chunks']:.0f} chunks, "
            f"{s['prefill_tokens']:.0f} tokens",
        ]
        if s["blocks_total"]:
            lines.append(
                f"paged    : prefix hit-rate "
                f"{s['prefix_hit_rate'] * 100:.1f}% "
                f"({s['prefix_hit_tokens']:.0f} tokens), blocks "
                f"{s['blocks_in_use']:.0f}/{s['blocks_total']:.0f} "
                f"(peak {s['blocks_peak']:.0f}), "
                f"preemptions {s['preemptions']:.0f}")
        if s["preemptions"]:
            lines.append(
                f"preempt  : {s['wasted_decode_tokens']:.0f} decode tokens "
                "discarded (regenerated exactly on re-serve)")
        lines += [
            f"ttft     : mean {s['ttft_mean_s'] * 1e3:.1f} ms, "
            f"p50 {s['ttft_p50_s'] * 1e3:.1f} ms, "
            f"p95 {s['ttft_p95_s'] * 1e3:.1f} ms",
            f"wall     : {s['wall_s']:.2f} s, "
            f"{s['tokens_per_s']:.0f} tok/s",
        ]
        return "\n".join(lines)
