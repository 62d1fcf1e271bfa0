"""Port parity: the serve engine's host-side modules.

``blocks``, ``slots``, ``queue``, ``metrics`` and ``slot_state`` are plain
Python and numpy in both packages, so the same operation sequences must
give EXACTLY equal results: return values, internal state, arrays and
floating-point quantile estimates bit for bit.
"""

import dataclasses

import numpy as np
import pytest

from repro.models.registry import get_config as jax_get_config
from repro.serve import blocks as JB
from repro.serve import metrics as JM
from repro.serve import queue as JQ
from repro.serve import slot_state as JS
from repro.serve import slots as JSl
from repro_torch.models.registry import get_config
from repro_torch.serve import blocks as B
from repro_torch.serve import metrics as M
from repro_torch.serve import queue as Q
from repro_torch.serve import slot_state as S
from repro_torch.serve import slots as Sl


def _state(a):
    return (list(a._free), dict(a._ref), dict(a._key_of), dict(a._index),
            list(a._cached), a.num_free, a.num_used, a.num_cached, repr(a))


def _call(obj, name, *args):
    try:
        return ("ok", getattr(obj, name)(*args))
    except Exception as e:       # both packages must fail the same way
        return ("err", type(e).__name__, str(e))


@pytest.mark.parametrize("seed", range(4))
def test_block_allocator_random_ops_identical(seed):
    rng = np.random.default_rng(seed)
    ours, ref = B.BlockAllocator(9, 4), JB.BlockAllocator(9, 4)
    assert B.SENTINEL == JB.SENTINEL
    prompts = [tuple(rng.integers(0, 5, size=int(rng.integers(1, 14))))
               for _ in range(6)]
    for _ in range(300):
        op = rng.integers(0, 6)
        live = sorted(ref._ref)
        blk = int(rng.choice(live)) if live else 1
        prompt = list(prompts[rng.integers(0, len(prompts))])
        if op == 0:
            args = ("alloc",)
        elif op == 1:
            args = ("decref", blk)
        elif op == 2:
            args = ("cow", blk)
        elif op == 3:
            keys = ref.prefix_keys(prompt)
            args = ("publish", blk, keys[0] if keys else (0,))
        elif op == 4:
            args = ("match_prefix", prompt)
        else:
            args = ("fork", [blk] if live else [])
        assert _call(ours, *args) == _call(ref, *args)
        assert _state(ours) == _state(ref)
        ours.assert_consistent()
    assert ours.blocks_for(13) == ref.blocks_for(13)


def test_slot_table_identical_device_inputs():
    reqs = [(Q.Request(i, list(range(3 + i)), 4 + i),
             JQ.Request(i, list(range(3 + i)), 4 + i)) for i in range(3)]
    ours = Sl.SlotTable(3, 16, block_size=4)
    ref = JSl.SlotTable(3, 16, block_size=4)

    def same():
        for a, b in zip(ours.decode_inputs(), ref.decode_inputs()):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ours.block_tables(),
                                      ref.block_tables())
        np.testing.assert_array_equal(ours.rec_rows(), ref.rec_rows())
        assert [s.index for s in ours.free()] == [s.index for s in
                                                  ref.free()]
        assert ours.youngest_busy().index == ref.youngest_busy().index

    for (ro, rr), blocks in zip(reqs, ([1, 2], [3], [4, 5, 6])):
        so, sr = ours.free()[0], ref.free()[0]
        ours.assign(so, ro)
        ref.assign(sr, rr)
        so.blocks, sr.blocks = list(blocks), list(blocks)
    same()
    for i, tok in ((0, 7), (2, 9)):
        ours.activate(ours.slots[i], tok)
        ref.activate(ref.slots[i], tok)
    same()
    for t in (ours, ref):
        t.slots[0].blocks = []
        t.release(t.slots[0])
    same()
    np.testing.assert_array_equal(ours.block_table_row(ours.slots[2]),
                                  ref.block_table_row(ref.slots[2]))
    assert (Sl.FREE, Sl.PREFILL, Sl.ACTIVE) == (JSl.FREE, JSl.PREFILL,
                                                JSl.ACTIVE)


@pytest.mark.parametrize("spec", [
    "immediate", "poisson:7.5", "burst:20,0.25", "burst:5,0.5,2.0",
    "trace:0,0.5,0.5,2,3.25,4,9"])
def test_arrival_specs_identical(spec):
    for seed in (0, 3):
        assert Q.parse_arrival_spec(spec, 7, seed) == \
            JQ.parse_arrival_spec(spec, 7, seed)


def test_trace_file_and_errors_identical(tmp_path):
    f = tmp_path / "arrivals.txt"
    f.write_text("0\n0.25\n\n1.5\n")
    assert Q.trace_arrivals(str(f)) == JQ.trace_arrivals(str(f))
    for bad in ("poisson:0", "burst:1", "trace:1,0", "nope"):
        assert _call(Q, "parse_arrival_spec", bad, 2) == \
            _call(JQ, "parse_arrival_spec", bad, 2)


def test_request_queue_order_identical():
    rng = np.random.default_rng(0)
    times = rng.integers(0, 4, size=20) * 0.5
    ours, ref = Q.RequestQueue(), JQ.RequestQueue()
    ours.submit([Q.Request(i, [1], 1, float(t)) for i, t in
                 enumerate(times)])
    ref.submit([JQ.Request(i, [1], 1, float(t)) for i, t in
                enumerate(times)])
    got, want = [], []
    for now in (0.0, 0.5, 1.0, 1.5, 2.0):
        while (r := ours.pop_ready(now)) is not None:
            got.append(r.req_id)
        while (r := ref.pop_ready(now)) is not None:
            want.append(r.req_id)
        assert ours.next_arrival() == ref.next_arrival()
    assert got == want and len(got) == 20


@pytest.mark.parametrize("q", [0.5, 0.9, 0.99])
def test_p2_quantile_identical(q):
    rng = np.random.default_rng(1)
    ours, ref = M.P2Quantile(q), JM.P2Quantile(q)
    for x in np.concatenate([rng.exponential(2.0, 300),
                             rng.standard_normal(200)]):
        ours.add(float(x))
        ref.add(float(x))
        assert ours.value == ref.value


def test_serve_metrics_step_clock_identical():
    ours = M.ServeMetrics(max_slots=2, clock="step", step_s=0.01)
    ref = JM.ServeMetrics(max_slots=2, clock="step", step_s=0.01)
    script = [("on_submit", 0, 0.0, 5), ("on_submit", 1, 0.02, 3),
              ("start",), ("on_admit", 0), ("on_prefill_chunk", 5),
              ("tick",), ("on_first_token", 0), ("on_blocks", 2, 8),
              ("wait_until", 0.05), ("on_admit", 1), ("on_decode_step", 1),
              ("on_token", 0), ("on_prefix_lookup", 4, 8), ("tick",),
              ("on_first_token", 1), ("on_preempt", 1),
              ("on_queue_depth", 1), ("on_admit", 1), ("tick",),
              ("on_first_token", 1), ("on_decode_step", 2), ("on_token", 0),
              ("on_token", 1), ("on_finish", 0), ("on_finish", 1),
              ("stop",)]
    for name, *args in script:
        getattr(ours, name)(*args)
        getattr(ref, name)(*args)
    assert ours.summary() == ref.summary()
    assert ours.report() == ref.report()


def test_state_plan_identical():
    ours = S.StatePlan.resolve(get_config("gemma2-2b"), "paged")
    ref = JS.StatePlan.resolve(jax_get_config("gemma2-2b"), "paged")
    assert dataclasses.astuple(ours) == dataclasses.astuple(ref)
    assert ours.describe() == ref.describe() == "26×paged"
    rows, jrows = S.RecurrentRows(3), JS.RecurrentRows(3)
    assert [rows.alloc() for _ in range(3)] == [jrows.alloc()
                                                for _ in range(3)]
    assert _call(rows, "alloc") == _call(jrows, "alloc")
