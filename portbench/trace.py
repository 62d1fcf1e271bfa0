"""Device trace of a few steps with ``torch.profiler``, reduced to what the
per-layer readers and the result's ``device`` and ``breakdown`` need.

Two passes, because recording every host operation slows the host by
more than the device's idle share: the steps whose device time the
metrics read are traced with device activity only, each step timed by the
host clock and ending synchronised (the traced window is the sum of those
times, and the device was busy for the union of its operations'
intervals); one more step is traced with host operations too, only to
name the longest idle gaps, each by the host operation that began last
before the gap ended and was still open in it (those gaps include the
host tracing's own cost).
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, List, Tuple

import torch

STEP_SPAN = "portbench.step"


@dataclass
class Trace:
    """Times in seconds."""

    kernels: List[Tuple[str, float, float]] = field(default_factory=list)
    step_seconds: List[float] = field(default_factory=list)
    gaps: List[List] = field(default_factory=list)
    # host clock (``time.time_ns()``) as each device-traced step's
    # synchronise returned: every kernel the step launched has ended
    synced_ns: List[int] = field(default_factory=list)

    def kernel_seconds(self, match: Callable[[str], bool]) -> float:
        return sum(e - s for n, s, e in self.kernels if match(n))

    def busy_s(self) -> float:
        """The union of the device operations' intervals."""
        busy, end = 0.0, -float("inf")
        for s, e in sorted((s, e) for _, s, e in self.kernels):
            if e > end:
                busy += e - max(s, end)
                end = e
        return busy

    def window_s(self) -> float:
        return sum(self.step_seconds)

    def breakdown(self, n: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps of the host-traced step."""
        by_name = defaultdict(float)
        for name, s, e in self.kernels:
            by_name[name] += e - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k[:200], v] for k, v in ops],
                "idle_gaps": self.gaps[:n]}


def _times(e) -> Tuple[float, float]:
    if hasattr(e, "start_ns"):
        s = e.start_ns()
        return s * 1e-9, (s + e.duration_ns()) * 1e-9
    s = e.start_us()
    return s * 1e-6, (s + e.duration_us()) * 1e-6


def _events(prof):
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        s, t = _times(e)
        yield e.name(), e.device_type() == cuda, s, t


def _named_gaps(events, n: int) -> List[List]:
    kernels = sorted((s, t) for name, dev, s, t in events
                     if dev and name != STEP_SPAN)
    spans = [(s, t) for name, dev, s, t in events
             if name == STEP_SPAN and not dev]
    host = sorted((s, t, name) for name, dev, s, t in events
                  if not dev and name != STEP_SPAN
                  and not name.startswith("cuda"))
    gaps = []
    for a, b in spans:
        cur = a
        for s, e in kernels:
            if e <= a or s >= b:
                continue
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if b > cur:
            gaps.append((cur, b))
    gaps.sort(key=lambda g: g[0] - g[1])
    starts = [s for s, _, _ in host]
    out = []
    for s, e in gaps[:n]:
        name = "idle"
        for i in range(bisect.bisect_left(starts, e) - 1, -1, -1):
            hs, he, op = host[i]
            if he > s:
                name = op
                break
            if hs < s - 1.0:
                break
        out.append([name[:200], e - s])
    return out


def profile(step: Callable[[], None], n: int, gaps: int = 10) -> Trace:
    """Run ``step`` ``n`` times under a device-only trace, then once more
    under a host and device trace, each run ending synchronised."""
    tr = Trace()
    cuda = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=cuda) as prof:
        for _ in range(n):
            t = time.monotonic()
            step()
            torch.cuda.synchronize()
            tr.synced_ns.append(time.time_ns())
            tr.step_seconds.append(time.monotonic() - t)
    tr.kernels = [(name, s, t) for name, dev, s, t in _events(prof)
                  if dev and name != STEP_SPAN]
    both = cuda + [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=both) as prof:
        with torch.profiler.record_function(STEP_SPAN):
            step()
            torch.cuda.synchronize()
    tr.gaps = _named_gaps(list(_events(prof)), gaps)
    return tr
