"""``chip_smoke.py``'s slice-8 checks, run on the CPU.

  * the Table 1 phase passes the port's simulator and rejects one cycle
    off the pins;
  * the schedules phase, at small payloads (``SCHEDULE_M`` cut down), passes
    the port's lowering on every schedule and shape and rejects a lowering
    that overwrites where the program adds;
  * the auto superstep phase runs at smoke size with a decode-add that
    counts like the kernel wrappers: its launch counts must equal steps x
    (buckets with that codec) x log2(world), which the phase asserts; a
    wrapper that misses one bucket's launches is rejected, and so is a
    step-0 loss other than the fixed run's; every bucket of the plan is
    reduce-scattered on real gradients through the decode-add and through
    the plain versions, and an int8 decode-add that rounds the product
    before the add at one bucket's hop lengths only is rejected;
  * the forced-schedule phase (ring and tree with the int8 codec asked
    for) launches no decode-add.
"""

import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.core import collectives
from repro_torch.kernels.tree_reduce import ops as tops, ref as tref
from repro_torch.launch import train as train_cli
from repro_torch.models.registry import get_config
from repro_torch.optim.compression import Bf16Codec, Int8Codec

ROOT = Path(__file__).resolve().parents[1]
ARCH = "gemma2-2b-smoke"
STEPS = 2
SMOKE_TRAIN_ARGS = ["--arch", ARCH, "--device", "cpu", "--devices", "4",
                    "--steps", str(STEPS), "--batch", "8", "--seq", "32",
                    "--schedule", "fractal", "--bucket-mb", "0.25",
                    "--seed", "0"]
CODECS = {"bf16": Bf16Codec(), "int8": Int8Codec()}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """These checks run many small ops, which a thread pool per worker
    only slows when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def smoke(monkeypatch):
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "TRAIN_ARGS", SMOKE_TRAIN_ARGS)
    monkeypatch.setattr(mod, "SCHEDULE_M", 8 * 1024)
    return mod


def test_table1_phase_passes_the_port(smoke, capsys):
    assert smoke.phase_table1() >= 0
    out = capsys.readouterr().out
    assert "table1/16x16/naive,cycles=9381" in out
    assert "table1/8x8/fsync_p,cycles=18;paper=18;ratio=1.00" in out


def test_table1_phase_rejects_a_drifted_cycle(smoke, monkeypatch):
    from repro_torch.core import simulator
    real = simulator.simulate_config

    def drifted(name, *a, **k):
        row = dict(real(name, *a, **k))
        if name == "4x4":
            row["xy"] += 1
        return row

    monkeypatch.setattr(simulator, "simulate_config", drifted)
    with pytest.raises(AssertionError, match="4x4"):
        smoke.phase_table1()


def test_schedules_phase_passes_the_lowering(smoke, capsys):
    assert smoke.phase_schedules(torch, torch.device("cpu")) == {}
    n = sum(len(names) * (2 if (s := int(torch.tensor(shape).prod())) &
                          (s - 1) == 0 else 1)
            for shape, names in smoke.SCHEDULE_SHAPES)
    n_xla = sum(2 for _, names in smoke.SCHEDULE_SHAPES if "xla" in names)
    assert f"{2 * n - n_xla} checks" in capsys.readouterr().out


def _overwriting(real):
    """The lowering with every reduce turned into an overwrite."""
    def lower(x, prog):
        steps = tuple(dataclasses.replace(st, transfers=tuple(
            dataclasses.replace(t, reduce=False) for t in st.transfers))
            for st in prog.steps)
        return real(x, dataclasses.replace(prog, steps=steps))
    return lower


def test_schedules_phase_rejects_an_overwriting_lowering(smoke,
                                                         monkeypatch):
    monkeypatch.setattr(collectives, "ir_all_reduce",
                        _overwriting(collectives.ir_all_reduce))
    with pytest.raises(AssertionError, match="sum over ranks"):
        smoke.phase_schedules(torch, torch.device("cpu"))


def _two_roundings(keep, q, scale):
    prod = q.float().view(-1, 128) * scale.view(-1, 1)
    return keep + prod.view(keep.shape)


def _counting(skip_lengths=(), off_lengths=()):
    """A decode-add that counts like the kernel wrappers; calls whose kept
    half has one of ``skip_lengths`` elements a rank are not counted, and
    int8 calls at one of ``off_lengths`` round the product before the
    add."""
    def decode_add(keep, wire, codec):
        counted = keep.shape[-1] not in skip_lengths
        if codec.name == "bf16":
            tops.BF16_LAUNCHES += counted
            return tref.decode_add_bf16(keep, wire["x"])
        tops.INT8_LAUNCHES += counted
        if keep.shape[-1] in off_lengths:
            return _two_roundings(keep, wire["q"], wire["scale"])
        return tref.decode_add_int8(keep, wire["q"], wire["scale"])
    return decode_add


def _auto_engine(smoke):
    from repro_torch.core.bsp import BSPConfig
    from repro_torch.core.superstep import engine_for
    from repro_torch.models import transformer as T
    from repro_torch.weights import reference_leaves
    args = train_cli.parse_args(SMOKE_TRAIN_ARGS + smoke.TRAIN_AUTO)
    cfg = get_config(ARCH)
    return engine_for(reference_leaves(T.init_params(cfg, device="meta"),
                                       cfg),
                      BSPConfig(schedule="auto", bucket_mb="auto",
                                bucket_codec="auto"),
                      args.devices, force_dtype=torch.float32, zero1=True)


def _hops(b):
    """The kept halves' lengths of bucket ``b``'s reduce-scatter at world 4."""
    return (b.length // 2, b.length // 4)


@pytest.fixture(scope="module")
def first_loss(_one_thread):
    """Step 0's loss of the fixed-schedule run (phase 5's role)."""
    args = train_cli.parse_args(SMOKE_TRAIN_ARGS + [
        "--steps", "1", "--bucket-codec", "int8"])
    return train_cli.run(get_config(ARCH), args)["history"][0]["loss"]


def test_auto_phase_counts_every_reduce_hop(smoke, monkeypatch, capsys,
                                            first_loss):
    monkeypatch.setattr(collectives, "decode_add", _counting())
    launches = smoke.phase_train_auto(torch, tops, tref, CODECS,
                                      get_config(ARCH), first_loss)
    out = capsys.readouterr().out
    assert "[dp]" in out and "plan: " in out
    # every bucket held to the plain versions on real gradients
    assert out.count("through the kernels is bit-identical") == 4
    # the smoke plan: b0 bf16, b1-b3 int8 (the reference's picks)
    assert launches == {"bf16": STEPS * 1 * 2, "int8": STEPS * 3 * 2}


def test_auto_phase_rejects_a_bucket_left_uncounted(smoke, monkeypatch,
                                                    first_loss):
    b = _auto_engine(smoke).buckets[-1]
    monkeypatch.setattr(collectives, "decode_add", _counting(_hops(b)))
    with pytest.raises(AssertionError, match="launches"):
        smoke.phase_train_auto(torch, tops, tref, CODECS, get_config(ARCH),
                               first_loss)


def test_auto_phase_rejects_a_decode_add_off_its_plain_version(
        smoke, monkeypatch, first_loss):
    eng = _auto_engine(smoke)
    # the shortest int8 bucket, not the largest: every hop length counts
    b = min((b for b, c in zip(eng.buckets, eng.codec_names) if c == "int8"),
            key=lambda b: b.length)
    assert b.length < max(x.length for x in eng.buckets)
    monkeypatch.setattr(collectives, "decode_add",
                        _counting(off_lengths=_hops(b)))
    with pytest.raises(AssertionError, match=f"int8, b{b.index}"):
        smoke.phase_train_auto(torch, tops, tref, CODECS, get_config(ARCH),
                               first_loss)


def test_auto_phase_rejects_another_first_loss(smoke, monkeypatch,
                                               first_loss):
    monkeypatch.setattr(collectives, "decode_add", _counting())
    with pytest.raises(AssertionError, match="step-0 loss"):
        smoke.phase_train_auto(torch, tops, tref, CODECS, get_config(ARCH),
                               first_loss + 1e-6)


def test_forced_phase_launches_no_codec(smoke, monkeypatch, capsys):
    monkeypatch.setattr(collectives, "decode_add", _counting())
    seen = smoke.phase_train_forced(torch, tops, get_config(ARCH))
    assert seen == {name: {"bf16": 0, "int8": 0}
                    for name in smoke.TRAIN_FORCED}
    assert capsys.readouterr().out.count("codec normalised to none") == 2
