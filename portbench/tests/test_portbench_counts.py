"""The benchmark's counts, layout and trace reduction against hand counts
and against the port's own bucket plan."""

import math
from types import SimpleNamespace

import pytest
import torch

from portbench import counts, harness
from portbench.reference import bsp as ref
from portbench.reference import lm
from portbench.tests.small import CELLS
from portbench.trace import Trace

TINY = lm.ModelSpec(name="tiny", n_layers=2, d_model=8, n_heads=2,
                    n_kv_heads=1, head_dim=4, d_ff=16, vocab=32, qkv_bias=True,
                    tied=True, rope_theta=1e4, norm_eps=1e-6)


def test_train_flops_by_hand():
    t = {"global_batch": 2, "seq_len": 3}
    # a layer: q 8x8, k 8x4, v 8x4, o 8x8, swiglu 3 x 8x16 = 560
    layer = 64 + 32 + 32 + 64 + 3 * 128
    matmul = 2 * (6 * 2 * layer * 3 + 6 * 8 * 32 * 3)
    # causal pairs of 3 positions: 6; 4 * heads * head_dim each, x3
    attention = 2 * 2 * 3 * 4 * 2 * 4 * 6
    f = lm.train_flops(TINY, t)
    assert f == {"matmul": matmul, "attention": attention,
                 "total": matmul + attention}


def test_decode_add_elements_by_hand():
    layout = ref.Layout(ref.Model(lm, TINY), 4, 0.0001)
    want = sum(4 * (b.length // 2 + b.length // 4) for b in layout.buckets)
    assert counts.decode_add_elements(layout) == want
    assert counts.decode_add_bytes(layout, "int8") == want * (9 + 1 / 32)
    assert counts.decode_add_bytes(layout, "bf16") == want * 10


def test_error_feedback_roofline_by_hand():
    """16 B an element of every bucket's [world, length] rows, at the
    HBM bandwidth, over the device time of E1's kernels."""
    layout = ref.Layout(ref.Model(lm, TINY), 4, 0.0001)
    per_step = counts.error_feedback_bytes(layout)
    assert per_step == 4 * 4 * 4 * sum(b.length for b in layout.buckets)
    read = harness.reader("error_feedback_roofline")
    ef = "void error_feedback_kernel<0, true>(float*, float*, long)"
    ctx = _ctx(trace=Trace(kernels=[(ef, 0.0, 0.2), (ef, 0.3, 0.5),
                                    ("decode_add_int8_kernel", 0.5, 0.6)],
                           step_seconds=[2.0]),
               profiled_steps=2, error_feedback_bytes=0.3e12)
    # 2 steps of 0.3 TB at 3 TB/s: 0.2 s, over 0.4 s of E1
    assert math.isclose(read(ctx), 50.0)
    assert read(_ctx(error_feedback_bytes=0.3e12)) is None
    assert read(_ctx(trace=ctx.trace, error_feedback_bytes=None)) is None


@pytest.mark.parametrize("name", CELLS)
def test_layout_is_the_ports_bucket_plan(name):
    """At the cell's full size (shapes only): the benchmark's buckets,
    their padding and every parameter's place equal the port's engine."""
    from portbench.drivers.bsp_train import program_config
    from repro_torch.core.bsp import BSPConfig
    from repro_torch.core.superstep import engine_for
    from repro_torch.models import transformer as T
    from repro_torch.weights import reference_leaves
    cell = harness.load_cell(name)
    model, t = ref.Model.of(cell.config), cell.traffic
    cfg = program_config(cell.config, model)
    leaves = reference_leaves(T.init_params(cfg, device="meta"), cfg)
    eng = engine_for(leaves, BSPConfig(schedule=t["schedule"],
                                       bucket_mb=float(t["bucket_mb"]),
                                       bucket_codec=t["bucket_codec"]),
                     t["world"], force_dtype=torch.float32, zero1=True)
    layout = ref.Layout(model, t["world"], t["bucket_mb"])
    assert [(b.raw, b.length) for b in eng.buckets] == \
        [(b.raw, b.length) for b in layout.buckets]
    assert list(eng.shard_offsets()) == layout.shard_offsets()
    mine = [[s.numel for s in b.segments] for b in layout.buckets]
    theirs = [[p.numel() for i in b.leaf_ids for p in leaves[i].parts]
              for b in eng.buckets]
    assert mine == theirs
    assert layout.rev == eng_rev(t["world"])


def eng_rev(world):
    from repro_torch.core.collectives import bit_reversed_index
    return bit_reversed_index(world).tolist()


def test_trace_busy_window_and_gaps():
    tr = Trace(kernels=[("a", 0.0, 1.0), ("b", 0.5, 1.5), ("c", 3.0, 4.0)],
               step_seconds=[2.0, 3.0], gaps=[["aten::mm", 1.5]])
    assert tr.busy_s() == 2.5
    assert tr.window_s() == 5.0
    bd = tr.breakdown()
    assert bd["device_ops"] == [["a", 1.0], ["b", 1.0], ["c", 1.0]]
    assert bd["idle_gaps"] == [["aten::mm", 1.5]]


def test_named_gaps():
    from portbench.trace import STEP_SPAN, _named_gaps
    events = [(STEP_SPAN, False, 0.0, 10.0), ("k1", True, 1.0, 2.0),
              ("k2", True, 6.0, 9.0), ("aten::add", False, 2.5, 3.0),
              ("aten::mm", False, 0.2, 0.4)]
    assert _named_gaps(events, 10) == [["aten::add", 4.0],
                                       ["aten::mm", 1.0], ["idle", 1.0]]


def _ctx(**kw):
    base = dict(trace=Trace(kernels=[("nvjet_tst_x", 0.0, 0.5),
                                     ("decode_add_int8_kernel", 0.5, 0.6),
                                     ("elementwise", 0.6, 1.0)],
                            step_seconds=[2.0]),
                flops={"matmul": 100e12, "attention": 10e12,
                       "total": 110e12},
                window_steps=4, window_s=10.0, profiled_steps=1,
                peaks={"bf16_flops": 1000e12, "hbm_bytes_per_s": 3e12},
                decode_add_bytes={"int8": 0.15e12})
    base.update(kw)
    return SimpleNamespace(**base)


def test_layer_metric_readers():
    read = {n: harness.reader(n) for n in (
        "mfu.train", "gemm_roofline.train", "device_idle.train",
        "decode_add_int8_roofline", "decode_add_bf16_roofline")}
    ctx = _ctx()
    assert math.isclose(read["mfu.train"](ctx), 100 * 110e12 * 4 / 10 / 1e15)
    # the dense and attention FLOPs (0.11 s at peak) over 0.5 s of GEMMs
    assert math.isclose(read["gemm_roofline.train"](ctx), 100 * 0.11 / 0.5)
    # 1.0 s busy in the profiled step against 2.5 s a step untraced
    assert math.isclose(read["device_idle.train"](ctx), 60.0)
    assert math.isclose(read["decode_add_int8_roofline"](ctx),
                        100 * 0.05 / 0.1)
    # nothing to read: no bf16 bucket, no GEMM kernel, no step
    assert read["decode_add_bf16_roofline"](ctx) is None
    assert read["gemm_roofline.train"](_ctx(trace=Trace())) is None
    assert read["mfu.train"](_ctx(window_steps=0)) is None
    assert read["device_idle.train"](_ctx(window_steps=0)) is None
