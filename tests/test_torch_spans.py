"""The span recorder (``runtime/spans.py``) and the spans of the BSP
superstep (``trainer.make_bsp_train_step``'s ``step_fn``).

  * off: with no profiler active a step records nothing and every span
    the step opens is the one shared null context;
  * on: under ``torch.profiler.profile`` one step of the int8-codec
    superstep records one ``bsp.step`` holding ``bsp.compute`` and
    ``bsp.sync``, and under ``bsp.sync`` exactly one ``bsp.ef`` (on a
    codec'd bucket), ``bsp.reduce_scatter``, ``bsp.zero1`` and
    ``bsp.all_gather`` per bucket, host intervals nested as the parents
    say;
  * recording changes no bit of the params, the moments or the EF state;
  * the host clock is the profiler's: a ``record_function`` range opened
    inside a span starts inside the span's host interval;
  * the recorder keeps the last ``KEEP`` steps.

The card's test (marked ``cuda``, skips here) reads the device windows.
"""

import pytest
import torch

from repro_torch.core.bsp import BSPConfig
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_config
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import spans
from repro_torch.runtime.trainer import make_bsp_train_step

ARCH = "gemma2-2b-smoke"
WORLD = 4
BATCH, SEQ = 8, 32
PHASES = ("bsp.ef", "bsp.reduce_scatter", "bsp.zero1", "bsp.all_gather")
CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def _fresh():
    spans.clear()
    yield
    spans.clear()


def _step(device="cpu"):
    cfg = get_config(ARCH)
    step, init_state = make_bsp_train_step(
        cfg, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=100),
        BSPConfig(bucket_mb=0.25, bucket_codec="int8"), WORLD,
        device=device)
    return step, init_state, lambda: init_state(
        T.init_params(cfg, 0, device=device))


def _batch(device="cpu"):
    g = torch.Generator().manual_seed(5)
    vocab = get_config(ARCH).vocab_size
    tok = torch.randint(0, vocab, (BATCH, SEQ + 1), generator=g)
    return {"tokens": tok[:, :-1].to(device), "labels": tok[:, 1:].to(device)}


@pytest.fixture(scope="module")
def built():
    return _step()


def _contains(outer, inner):
    return (outer.host_start_ns <= inner.host_start_ns
            and inner.host_end_ns <= outer.host_end_ns)


def test_off_records_nothing(built, monkeypatch):
    step, _, fresh = built
    seen = []
    for name in ("step", "span"):
        real = getattr(spans, name)

        def spy(*a, _real=real, **kw):
            out = _real(*a, **kw)
            seen.append(out)
            return out
        monkeypatch.setattr(spans, name, spy)
    step(fresh(), _batch())
    assert spans.steps() == []
    # the root and the compute and sync spans, at least, were asked for
    assert len(seen) >= 3
    assert all(s is spans._NULL for s in seen)
    assert spans.span("bsp.ef", bucket=0) is spans.span("bsp.sync")


def test_on_records_the_superstep(built):
    step, init_state, fresh = built
    engine = init_state.engine
    with torch.profiler.profile(activities=CPU):
        step(fresh(), _batch())
    assert not spans._on
    (rec,) = spans.steps()
    by_id = {s.id: s for s in rec}
    root = rec[0]
    assert root.name == "bsp.step" and root.parent is None
    assert [s.name for s in rec].count("bsp.step") == 1
    assert {s.step for s in rec} == {0}
    compute = [s for s in rec if s.name == "bsp.compute"]
    sync = [s for s in rec if s.name == "bsp.sync"]
    assert len(compute) == len(sync) == 1
    compute, sync = compute[0], sync[0]
    assert compute.parent == sync.parent == root.id
    assert compute.host_end_ns <= sync.host_start_ns
    codecs = engine.bucket_codecs
    assert any(c is not None for c in codecs)
    for b in range(engine.n_buckets):
        for name in PHASES:
            found = [s for s in rec if s.name == name
                     and s.attrs == {"bucket": b}]
            want = 0 if name == "bsp.ef" and codecs[b] is None else 1
            assert len(found) == want, (name, b)
            assert all(s.parent == sync.id for s in found)
    assert len(rec) == 3 + sum(4 if c is not None else 3 for c in codecs)
    for s in rec:
        assert s.host_start_ns <= s.host_end_ns
        assert s.device_ms is None          # no device windows on the CPU
        if s.parent is not None:
            assert _contains(by_id[s.parent], s)


def test_recording_changes_no_bit(built):
    step, _, fresh = built
    out = []
    for on in (False, True):
        state = fresh()
        if on:
            with torch.profiler.profile(activities=CPU):
                state, m = step(state, _batch())
            assert len(spans.steps()) == 1
        else:
            state, m = step(state, _batch())
            assert spans.steps() == []
        out.append((state, m))
    (a, ma), (b, mb) = out
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        assert torch.equal(x, y)
    assert torch.equal(ma["loss"], mb["loss"])


def _leaves(state):
    from repro_torch.weights import reference_leaves
    params = [p.detach() for leaf in reference_leaves(state.params, state.cfg)
              for p in leaf.parts]
    return params + [state.flat_mu, state.flat_nu, state.ef_residual]


def test_host_clock_is_the_profilers():
    with torch.profiler.profile(activities=CPU) as prof:
        with spans.step("t.step", 7):
            with spans.span("t.inner", k=1) as inner:
                with torch.profiler.record_function("t.range"):
                    pass
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "t.range"]
    assert inner.host_start_ns <= ev.start_ns() <= inner.host_end_ns
    (rec,) = spans.steps()
    assert [s.name for s in rec] == ["t.step", "t.inner"]
    assert rec[1].attrs == {"k": 1} and rec[1].step == 7


def test_keeps_the_last_steps_and_recovers_from_a_raise():
    with torch.profiler.profile(activities=CPU):
        for i in range(spans.KEEP + 3):
            with spans.step("t.step", i):
                with spans.span("t.inner"):
                    pass
        with pytest.raises(ValueError):
            with spans.step("t.step", 99):
                with spans.span("t.inner"):
                    raise ValueError("inside a step")
        assert not spans._on and not spans._open
        assert spans.span("t.after") is spans._NULL
    kept = spans.steps()
    assert len(kept) == spans.KEEP
    assert [r[0].step for r in kept] == list(range(4, spans.KEEP + 3)) + [99]
    assert all(r[0].host_end_ns is not None for r in kept)


@pytest.mark.cuda
def test_cuda_device_windows():
    """On the card: every span of a recorded step has a positive device
    window, and each bucket's four phases fit in ``bsp.sync``'s."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card via pytest -m "
                    "cuda)")
    step, init_state, fresh = _step("cuda")
    state = fresh()
    state, _ = step(state, _batch("cuda"))          # builds the kernels
    cuda = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=cuda):
        state, m = step(state, _batch("cuda"))
        torch.cuda.synchronize()
    (rec,) = spans.steps()
    assert rec[0].name == "bsp.step" and rec[0].step == 1
    for s in rec:
        assert s.device_ms is not None and s.device_ms > 0, (s.name,
                                                              s.attrs)
    sync = next(s for s in rec if s.name == "bsp.sync")
    for b in range(init_state.engine.n_buckets):
        four = sum(s.device_ms for s in rec
                   if s.name in PHASES and s.attrs == {"bucket": b})
        assert four <= sync.device_ms
    assert sum(s.device_ms for s in rec if s.name in PHASES) \
        <= sync.device_ms
