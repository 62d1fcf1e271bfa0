"""Port parity: the serve soak (``serve/soak.py``) and the engine's fault
hooks, on the CPU.

gemma2-2b-smoke with the reference's parameters, greedy decoding and the
virtual step clock, paged KV: the port's ``run_soak`` and the reference's
drive their engines through the same Poisson traffic and the same
``FaultPlan`` (an admission stall, then half the block pool confiscated).
Every trend row, the summary (its P² streaming quantiles included), the
baseline p99, the fault end and the recovery step must be EQUAL: host
logic on the same step clock, with tokens that agree
(``test_torch_serve_engine.py``).  ``hold_admission`` delays admission
and overlapping holds extend; a wall-clock engine is refused.
"""

import jax
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro.models.registry import get_config as jax_get_config
from repro.runtime.chaos import FaultPlan as JFaultPlan
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve import SoakConfig as JSoakConfig
from repro.serve import run_soak as jrun_soak
from repro_torch import weights
from repro_torch.models.registry import get_config
from repro_torch.runtime.chaos import FaultPlan
from repro_torch.serve import (EngineConfig, Request, ServeEngine,
                               SoakConfig, poisson_arrivals, run_soak)

ARCH = "gemma2-2b-smoke"
PLAN = "stall:steps=100..140;blocks:frac=0.5,steps=170..210"
STEPS, RATE = 300, 40.0
ECFG = dict(max_slots=4, max_len=32, prefill_chunk=8, chunks_per_step=2,
            kv_mode="paged", block_size=8, kv_blocks=17, clock="step")
SCFG = dict(steps=STEPS, window=30, warmup_steps=30, recovery_band=2.0,
            recovery_slack_s=0.01, recovery_steps=150)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops, which a thread pool per worker only slows when the
    suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    jp = JT.init_params(jcfg, jax.random.key(0))
    return cfg, jcfg, weights.from_jax_params(
        jax.tree.map(np.asarray, jp), cfg, device="cpu"), jp


def _requests(cfg, n, arrivals, cls, gen=(4, 12), plen=8, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(req_id=i,
                prompt=rng.integers(0, cfg.vocab_size, size=(plen,)).tolist(),
                max_new_tokens=int(rng.integers(gen[0], gen[1] + 1)),
                arrival_s=arrivals[i])
            for i in range(n)]


@pytest.fixture(scope="module")
def soaks(models):
    cfg, jcfg, p, jp = models
    n = int(RATE * STEPS * 0.01)
    arrivals = poisson_arrivals(n, RATE, seed=1)
    ours = run_soak(ServeEngine(cfg, p, EngineConfig(**ECFG)),
                    _requests(cfg, n, arrivals, Request, seed=2),
                    FaultPlan.parse(PLAN), SoakConfig(**SCFG))
    theirs = jrun_soak(JServeEngine(jcfg, jp, JEngineConfig(**ECFG)),
                       _requests(cfg, n, arrivals, JRequest, seed=2),
                       JFaultPlan.parse(PLAN), JSoakConfig(**SCFG))
    return ours, theirs


def _same(a, b):
    """Equal, NaN included (an empty window's quantiles are NaN)."""
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(b[k], float) and np.isnan(b[k]):
            assert np.isnan(a[k]), k
        else:
            assert a[k] == b[k], (k, a[k], b[k])


def test_trend_rows_equal_reference(soaks):
    ours, theirs = soaks
    assert len(ours.trend) == len(theirs.trend) == STEPS // SCFG["window"]
    for a, b in zip(ours.trend, theirs.trend):
        _same(a, b)


def test_summary_and_p2_quantiles_equal_reference(soaks):
    ours, theirs = soaks
    _same(ours.summary, theirs.summary)
    assert "ttft_p99_stream_s" in ours.summary
    assert ours.baseline_p99_s == theirs.baseline_p99_s


def test_recovery_verdict_equals_reference(soaks):
    ours, theirs = soaks
    assert ours.fault_end_step == theirs.fault_end_step == 210
    assert ours.recovered_step == theirs.recovered_step is not None
    assert ours.failures == theirs.failures == []
    assert ours.ok
    # the stall backs the queue up; the block window holds half the pool
    # (16 usable blocks) and hands it back when it closes
    assert max(r["queue_max"] for r in ours.trend
               if 100 < r["step"] <= 150) >= 3
    assert [r["blocks_held"] for r in ours.trend if r["step"] in
            (180, 210, 240)] == [8, 8, 0]
    assert ours.summary["queue_peak"] >= 3


def test_hold_admission_delays_first_token(models):
    cfg, _, p, _ = models
    eng = ServeEngine(cfg, p, EngineConfig(max_slots=2, max_len=32,
                                           prefill_chunk=8,
                                           chunks_per_step=2))
    eng.metrics.start()
    eng.submit(_requests(cfg, 1, [0.0], Request))
    eng.hold_admission(3)
    with pytest.raises(ValueError):
        eng.hold_admission(-1)
    for s in range(3):
        eng.step()
        assert len(eng.table.busy()) == 0, f"admitted during hold ({s})"
        assert len(eng.queue) == 1
    eng.step()
    assert len(eng.table.busy()) == 1
    eng.hold_admission(2)
    eng.hold_admission(1)
    assert eng._admission_hold == 2


def test_run_soak_requires_step_clock(models):
    cfg, _, p, _ = models
    eng = ServeEngine(cfg, p, EngineConfig(max_slots=2, max_len=32,
                                           prefill_chunk=8, clock="wall"))
    with pytest.raises(ValueError, match="virtual step clock"):
        run_soak(eng, [], FaultPlan(), SoakConfig(steps=1))
