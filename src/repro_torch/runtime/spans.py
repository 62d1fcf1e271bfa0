"""Spans of a training step, recorded only while a ``torch.profiler`` is
active.

``step(name, step_id, device)`` opens a step's root span.  It asks the
profiler once (``torch._C._autograd._profiler_enabled()``) whether it is
active; every ``span(name, **attrs)`` inside the step then reads a module
flag.  While no profiler is active both return one shared null context:
nothing is allocated or recorded, and a span costs the flag check.

A recorded span (``Span``) holds its name, its id and its parent's (the
enclosing span's), the step id, its attributes, and its host start and
end from ``time.time_ns()``, the clock of the profiler's host timestamps.
On a CUDA device it also records a pair of timing events on the device's
current stream, taken from a pool.  Its device window, ``Span.device_ms``,
is ``start.elapsed_time(end)``, resolved when first read (waiting for the
end event): on the step's one stream, the time the span holds the card's
timeline, its idle time included.

The spans of the last ``KEEP`` steps are kept; ``steps()`` returns them.
An operator reads them under their own profiler::

    with torch.profiler.profile(activities=[...]):
        for _ in range(n):
            state, m = step_fn(state, batch)
    for spans_of_step in spans.steps()[-n:]:
        for s in spans_of_step:
            print(s.name, s.attrs, s.host_start_ns, s.device_ms)

The recorder opens no ``torch.profiler.record_function`` range: the
profiler returns such a range as a device-typed event, and it would count
among the device's operations in the trace it is meant to explain.
"""

from __future__ import annotations

import contextlib
import itertools
import time
from collections import deque
from typing import Deque, List, Optional

import torch

# steps whose spans are kept
KEEP = 16

_NULL = contextlib.nullcontext()
_on = False                       # inside a step the profiler saw
_device: Optional[torch.device] = None   # the CUDA device of the step
_open: List["Span"] = []          # the spans open now, outermost first
_steps: Deque[List["Span"]] = deque()
_pool: List[torch.cuda.Event] = []
_ids = itertools.count()


def _event() -> torch.cuda.Event:
    return _pool.pop() if _pool else torch.cuda.Event(enable_timing=True)


class Span:
    """One recorded span; a context manager that records its ends."""

    __slots__ = ("name", "id", "parent", "step", "attrs", "host_start_ns",
                 "host_end_ns", "_events", "_ms")

    def __init__(self, name: str, step: int, attrs: dict):
        self.name = name
        self.id = next(_ids)
        self.parent = _open[-1].id if _open else None
        self.step = step
        self.attrs = attrs
        self.host_start_ns = self.host_end_ns = None
        self._events = None
        self._ms = None

    def __enter__(self):
        _open.append(self)
        self.host_start_ns = time.time_ns()
        if _device is not None:
            self._events = (_event(), _event())
            self._events[0].record(torch.cuda.current_stream(_device))
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[1].record(torch.cuda.current_stream(_device))
        self.host_end_ns = time.time_ns()
        _open.pop()
        return False

    @property
    def device_ms(self) -> Optional[float]:
        """The device window in ms; None off a CUDA device."""
        if self._ms is None and self._events is not None:
            start, end = self._events
            end.synchronize()
            self._ms = start.elapsed_time(end)
        return self._ms

    def _release(self) -> None:
        """Resolve the device window and give the events back."""
        if self._events is not None:
            self.device_ms
            _pool.extend(self._events)
            self._events = None


class _Root(Span):
    __slots__ = ("_dev",)

    def __init__(self, name: str, step: int, device):
        super().__init__(name, step, {})
        self._dev = device

    def __enter__(self):
        global _on, _device
        _steps.append([self])
        while len(_steps) > KEEP:
            for s in _steps.popleft():
                s._release()
        _on, _device = True, self._dev
        return super().__enter__()

    def __exit__(self, *exc):
        global _on, _device
        super().__exit__(*exc)
        _on, _device = False, None
        return False


def step(name: str, step_id: int, device=None):
    """The root span of one step, recorded on ``device`` (events only on a
    CUDA device) while a profiler is active; else the shared null
    context."""
    if not torch._C._autograd._profiler_enabled():
        return _NULL
    dev = torch.device(device) if device is not None else None
    return _Root(name, step_id,
                 dev if dev is not None and dev.type == "cuda" else None)


def span(name: str, **attrs):
    """A span inside the open step, or the shared null context when the
    step is not recorded."""
    if not _on:
        return _NULL
    s = Span(name, _open[0].step, attrs)
    _steps[-1].append(s)
    return s


def steps() -> List[List[Span]]:
    """The spans of each kept step, oldest step first; each step's in the
    order they opened, its root first."""
    return [list(s) for s in _steps]


def clear() -> None:
    """Forget every kept step."""
    while _steps:
        for s in _steps.popleft():
            s._release()
