"""What the program's own spans of its training step say of the steps the
benchmark profiled: the device windows of the BSP superstep's phases, and
the device's idle time put down to the phase the host was in.

The program (``repro_torch.runtime.spans``) records its spans while a
profiler is active, with host times from the profiler's clock and device
windows from CUDA events.  Read here are the recorded steps whose root
span (``bsp.step``) overlaps the traced device operations
(``ctx.trace.kernels``): the steps of the device-only pass, and not the
host-traced step after them.  Each value is a mean over those steps.

Idle is the gaps in the union of the device operations within a step's
host interval.  Each gap goes to the innermost span whose host interval
holds the gap's end, because the host launched the operation that ended
it; it counts under ``bsp.compute`` or ``bsp.sync`` when that span is the
phase or lies inside it, and for neither otherwise.

Clock check: no kernel of a step (a device operation that is not a copy
or a fill, starting after the previous step ended: after its recorded
host end and after the host's synchronise that followed it, where the
trace gives that) may start more than ``CLOCK_SLACK_S`` before the step's
host start.  A kernel cannot run before it is launched, so an earlier
start means the host and device clocks disagree, and nothing is read.
The step's last launches can start after its root span closes; the
synchronise waits for them, so they count for the step before.  Nothing
is read either from a program that records no spans or no device
windows.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

ROOT, COMPUTE, SYNC = "bsp.step", "bsp.compute", "bsp.sync"
CLOCK_SLACK_S = 50e-6
# device operations that are no kernel: copies and fills
NOT_KERNELS = ("Memcpy", "Memset")


@dataclass
class Split:
    """Means a step, in ms."""

    steps: int
    host_ms: float
    device_ms: Dict[str, float] = field(default_factory=dict)
    idle_ms: float = 0.0
    idle_by_phase: Dict[str, float] = field(default_factory=dict)
    idle_by_span: Dict[str, float] = field(default_factory=dict)


def _union(intervals: Sequence[Tuple[float, float]]
           ) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _gaps(busy, a: float, b: float) -> List[Tuple[float, float]]:
    """The parts of ``[a, b]`` outside the sorted, disjoint ``busy``."""
    out, cur = [], a
    for s, e in busy[max(bisect.bisect_left(busy, (a,)) - 1, 0):]:
        if s >= b:
            break
        if e <= cur:
            continue
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if cur < b:
        out.append((cur, b))
    return out


def _innermost_first(spans) -> List[Tuple[float, float, str, str]]:
    """``(host start, host end, name, phase)`` of each span in seconds,
    the deepest first; the phase is ``bsp.compute``, ``bsp.sync`` or
    ``neither``."""
    by_id = {s.id: s for s in spans}
    out = []
    for s in spans:
        depth, phase, cur = 0, None, s
        while cur is not None:
            if phase is None and cur.name in (COMPUTE, SYNC):
                phase = cur.name
            cur = by_id.get(cur.parent)
            depth += 1
        out.append((-depth, s.host_start_ns * 1e-9, s.host_end_ns * 1e-9,
                    s.name, phase or "neither"))
    return [t[1:] for t in sorted(out, key=lambda t: t[0])]


def split(kernels, recorded, synced_ns=()) -> Optional[Split]:
    """``kernels``: the traced device operations ``(name, start, end)`` in
    seconds; ``recorded``: the program's steps, each a list of spans (root
    first) with ``name``, ``id``, ``parent``, ``host_start_ns``,
    ``host_end_ns`` and ``device_ms``; ``synced_ns``: host times at which
    every kernel launched before them had ended."""
    if not kernels:
        return None
    first = min(s for _, s, _ in kernels)
    last = max(e for _, _, e in kernels)
    steps = [r for r in recorded
             if r and r[0].name == ROOT and r[0].host_end_ns is not None
             and r[0].host_start_ns * 1e-9 < last
             and r[0].host_end_ns * 1e-9 > first]
    if not steps or any(s.device_ms is None for r in steps for s in r):
        return None
    busy = _union([(s, e) for _, s, e in kernels])
    launched = sorted(s for name, s, _ in kernels
                      if not name.startswith(NOT_KERNELS))
    prev_end = max((r[0].host_end_ns * 1e-9 for r in recorded
                    if r and r[0].host_end_ns is not None
                    and r[0].host_end_ns < steps[0][0].host_start_ns),
                   default=-float("inf"))
    synced = sorted(ns * 1e-9 for ns in synced_ns)
    out = Split(steps=len(steps), host_ms=0.0)
    device = defaultdict(float)
    idle_phase = defaultdict(float)
    idle_span = defaultdict(float)
    n = len(steps)
    for r in steps:
        a, b = r[0].host_start_ns * 1e-9, r[0].host_end_ns * 1e-9
        j = bisect.bisect_right(synced, a)
        if j:
            prev_end = max(prev_end, synced[j - 1])
        i = bisect.bisect_right(launched, prev_end)
        if i < len(launched) and launched[i] <= b \
                and launched[i] < a - CLOCK_SLACK_S:
            return None
        prev_end = b
        out.host_ms += (b - a) * 1e3 / n
        for s in r:
            device[s.name] += s.device_ms / n
        inner = _innermost_first(r)
        for g0, g1 in _gaps(busy, a, b):
            name, phase = next(((name, phase) for s, e, name, phase in inner
                                if s <= g1 <= e), (ROOT, "neither"))
            ms = (g1 - g0) * 1e3 / n
            out.idle_ms += ms
            idle_span[name] += ms
            idle_phase[phase] += ms
    out.device_ms = dict(device)
    out.idle_by_phase = {k: idle_phase.get(k, 0.0)
                         for k in (COMPUTE, SYNC, "neither")}
    out.idle_by_span = dict(idle_span)
    return out


def read(ctx) -> Optional[Split]:
    """The split of the run's profiled steps, once a run; None where the
    program records no spans."""
    if not hasattr(ctx, "span_split"):
        try:
            from repro_torch.runtime import spans
        except ImportError:
            ctx.span_split = None
        else:
            ctx.span_split = split(ctx.trace.kernels, spans.steps(),
                                   ctx.trace.synced_ns)
    return ctx.span_split
