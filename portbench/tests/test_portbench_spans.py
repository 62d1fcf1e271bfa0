"""The spans reader (``portbench/spans.py``) on hand-made device operations
and span records, and the eight readers that take their numbers from it.

The timeline, in ms after an epoch-sized base (the profiler's clock):

  step A, host [0, 100]: compute [1, 50], sync [50, 99] holding bucket 0's
    ef [51, 60], reduce_scatter [60, 70], zero1 [70, 80] and all_gather
    [80, 90]; device operations [2, 40], [45, 55], [62, 75], [85, 98]:
    idle [0, 2] and [40, 45] end in compute, [55, 62] in reduce_scatter,
    [75, 85] in all_gather, [98, 100] at the step's end (neither);
  between the steps a copy [101, 102] (the loss read back), no phase;
  step B, host [110, 200]: compute [111, 150], sync [150, 199]; one device
    operation [112, 198]: idle [110, 112] in compute, [198, 200] neither;
  step C, host [300, 400]: the host-traced step, none of its device
    operations among the traced ones.
"""

import sys
from types import SimpleNamespace

import pytest

from portbench import harness, spans
from portbench.trace import Trace

BASE_NS = 1_760_000_000 * 10 ** 9
# seconds as floats at the epoch's size resolve 0.24 us: compare to 1 us
US = 1e-3


def approx(ms):
    return pytest.approx(ms, abs=US)
CELLS = ["qwen2.5-3b-10l.bsp-int8", "qwen2.5-3b-10l.bsp-bf16"]


def _s(ms):
    return (BASE_NS + round(ms * 1e6)) * 1e-9


class _Ids:
    n = 0


def _span(name, a, b, parent=None, device_ms=1.0, **attrs):
    _Ids.n += 1
    return SimpleNamespace(name=name, id=_Ids.n,
                           parent=None if parent is None else parent.id,
                           host_start_ns=BASE_NS + round(a * 1e6),
                           host_end_ns=BASE_NS + round(b * 1e6),
                           device_ms=device_ms, attrs=attrs)


def _step(a, b, compute, sync, buckets=(), scale=1.0):
    root = _span("bsp.step", a, b, device_ms=(b - a) * scale)
    c = _span("bsp.compute", *compute, root, (compute[1] - compute[0])
              * scale)
    s = _span("bsp.sync", *sync, root, (sync[1] - sync[0] - 2) * scale)
    out = [root, c, s]
    for i, phases in enumerate(buckets):
        for name, (p0, p1) in phases.items():
            out.append(_span(name, p0, p1, s, (p1 - p0 - 1) * scale,
                             bucket=i))
    return out


A_BUCKET = {"bsp.ef": (51, 60), "bsp.reduce_scatter": (60, 70),
            "bsp.zero1": (70, 80), "bsp.all_gather": (80, 90)}


def _timeline(extra_kernel=None):
    a = _step(0, 100, (1, 50), (50, 99), [A_BUCKET])
    b = _step(110, 200, (111, 150), (150, 199))
    c = _step(300, 400, (301, 350), (350, 399), scale=100.0)
    kernels = [("k", _s(2), _s(40)), ("k", _s(45), _s(55)),
               ("k", _s(62), _s(75)), ("k", _s(85), _s(98)),
               ("Memcpy DtoH (Device -> Pageable)", _s(101), _s(102)),
               ("k", _s(112), _s(198))]
    if extra_kernel is not None:
        kernels.append(("k", _s(extra_kernel), _s(extra_kernel + 0.001)))
    return kernels, [a, b, c]


def test_idle_goes_to_the_innermost_span_at_the_gap_end():
    kernels, recorded = _timeline()
    got = spans.split(kernels, recorded)
    assert got.steps == 2
    assert got.idle_by_phase == {"bsp.compute": approx((7 + 2) / 2),
                                 "bsp.sync": approx(17 / 2),
                                 "neither": approx(4 / 2)}
    assert got.idle_by_span == {"bsp.compute": approx(9 / 2),
                                "bsp.reduce_scatter": approx(7 / 2),
                                "bsp.all_gather": approx(10 / 2),
                                "bsp.step": approx(4 / 2)}
    assert got.idle_ms == approx(30 / 2)
    assert got.host_ms == approx((100 + 90) / 2)


def test_gaps_between_steps_count_for_no_step():
    kernels, recorded = _timeline()
    got = spans.split(kernels, recorded)
    # [100, 110] and the host-traced step's [300, 400] are counted nowhere
    assert sum(got.idle_by_phase.values()) == approx(got.idle_ms)
    assert got.idle_ms < (10 + 100) / 2


def test_the_host_traced_step_is_left_out():
    kernels, recorded = _timeline()
    got = spans.split(kernels, recorded)
    # step C's windows are 100 times larger: a mean over A and B only
    assert got.device_ms["bsp.step"] == approx((100 + 90) / 2)
    assert got.device_ms["bsp.compute"] == approx((49 + 39) / 2)
    assert got.device_ms["bsp.sync"] == approx((47 + 47) / 2)
    assert got.device_ms["bsp.reduce_scatter"] == approx(9 / 2)
    assert spans.split(kernels, recorded[:2]).device_ms == got.device_ms


@pytest.mark.parametrize("start,ok", [(109.97, True), (108.9, False),
                                      (100.5, False)])
def test_the_clock_check(start, ok):
    """A kernel 30 us before step B's host start passes; 1.1 ms or 9.5 ms
    before it (after step A ended) fails, and nothing is read; the copy
    between the steps is no kernel."""
    kernels, recorded = _timeline(extra_kernel=start)
    got = spans.split(kernels, recorded)
    assert (got is not None) == ok


@pytest.mark.parametrize("start,ok", [(100.5, True), (108.9, False)])
def test_the_clock_check_after_the_synchronise(start, ok):
    """A kernel step A launched last can start after A's root span closed
    (100 ms); the synchronise after A (returned at 103 ms) waited for it,
    so it is A's and passes; one at 108.9 ms, after the synchronise and
    1.1 ms before step B's host start, still fails."""
    kernels, recorded = _timeline(extra_kernel=start)
    got = spans.split(kernels, recorded, [BASE_NS + 103_000_000])
    assert (got is not None) == ok


def test_a_kernel_before_the_first_step_fails_the_check():
    kernels, recorded = _timeline()
    kernels.append(("k", _s(-0.2), _s(-0.1)))
    assert spans.split(kernels, recorded) is None


def test_nothing_to_read():
    kernels, recorded = _timeline()
    assert spans.split([], recorded) is None
    assert spans.split(kernels, []) is None
    for r in recorded:          # spans off the card: no device windows
        for s in r:
            s.device_ms = None
    assert spans.split(kernels, recorded) is None


READS = {"compute_device_ms.train": (49 + 39) / 2,
         "sync_device_ms.train": (47 + 47) / 2,
         "ef_device_ms.train": 8 / 2,
         "reduce_scatter_device_ms.train": 9 / 2,
         "zero1_device_ms.train": 9 / 2,
         "all_gather_device_ms.train": 9 / 2,
         "compute_idle_ms.train": 9 / 2,
         "sync_idle_ms.train": 17 / 2}


def _benchmark_reads(name):
    return any(m["name"] == name and m["workloads"] == CELLS
               for m in harness.benchmark()["per_layer"])


@pytest.mark.parametrize("name", sorted(READS))
def test_reader(name, monkeypatch):
    assert _benchmark_reads(name)
    kernels, recorded = _timeline()
    program = SimpleNamespace(steps=lambda: recorded)
    monkeypatch.setattr("repro_torch.runtime.spans.steps", program.steps)
    ctx = SimpleNamespace(trace=Trace(kernels=kernels))
    assert harness.reader(name)(ctx) == approx(READS[name])


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_reads_nothing_off_the_card(name, monkeypatch):
    """On the CPU: no device operations, and spans without device
    windows; and a program without the span recorder (ImportError)."""
    from repro_torch.runtime import spans as program
    monkeypatch.setattr(program, "steps", lambda: [
        [_span("bsp.step", 0, 1, device_ms=None)]])
    ctx = SimpleNamespace(trace=Trace(kernels=[]))
    assert harness.reader(name)(ctx) is None
    kernels, _ = _timeline()
    ctx = SimpleNamespace(trace=Trace(kernels=kernels))
    assert harness.reader(name)(ctx) is None
    import repro_torch.runtime
    monkeypatch.delattr(repro_torch.runtime, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.spans", None)
    ctx = SimpleNamespace(trace=Trace(kernels=kernels))
    assert harness.reader(name)(ctx) is None
