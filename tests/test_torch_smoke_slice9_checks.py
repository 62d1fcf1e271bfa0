"""``chip_smoke.py``'s slice-9 checks, run on the CPU with stand-ins.

  * phase [2] at the four new B7 shapes (G 8, 3, 16 and 48 at d 128,
    shorter rows than on the card) passes the emulation of the split
    kernel of ``tests/test_torch_smoke_checks.py`` and rejects a kernel
    whose second pass over the KV rows repeats the first pass's heads;
  * phase [5d] (``phase_train_auto`` with ``QWEN_TRAIN_ARGS``, here at
    qwen2.5-3b-smoke on the CPU with a decode-add that counts like the
    kernel wrappers): every bucket's int8 hops are counted, steps x
    buckets x log2(4), and a wrapper that misses one bucket is rejected;
  * phase [5e] (``phase_train_soak``) passes the port's soak at the
    reference's ``TrainSoakConfig`` and prints its timeline, saves and
    restore; a soak whose restore finds no checkpoint is rejected; the
    even-vs-uneven step reports BIT-IDENTICAL for the port's trainer and
    counts the differing elements for one whose pair step drops Neumaier's
    error term; the checkpoint directory needs room for four checkpoints.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.core import collectives
from repro_torch.kernels.paged_attention import ref
from repro_torch.kernels.tree_reduce import ops as tops, ref as tref
from repro_torch.launch import train as train_cli
from repro_torch.models.registry import get_config
from repro_torch.optim.compression import Bf16Codec, Int8Codec
from repro_torch.runtime import soak as soak_mod
from repro_torch.runtime import trainer
from repro_torch.runtime.soak import TrainSoakConfig
from test_torch_smoke_checks import _Ops, emulated_split_kernel

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen2.5-3b-smoke"
STEPS = 2
QWEN_SMOKE_ARGS = ["--arch", ARCH, "--device", "cpu", "--devices", "4",
                   "--steps", str(STEPS), "--batch", "8", "--seq", "32",
                   "--lr", "3e-4", "--seed", "0"]
CODECS = {"bf16": Bf16Codec(), "int8": Int8Codec()}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops, which a thread pool per worker only slows when the
    suite's workers share the cores."""
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
    monkeypatch.setattr(mod, "QWEN_TRAIN_ARGS",
                        QWEN_SMOKE_ARGS + mod.TRAIN_AUTO)
    return mod


NEW_SHAPES = [dict(Hkv=2, G=8, d=128, bs=16), dict(Hkv=8, G=3, d=128, bs=16),
              dict(Hkv=4, G=16, d=128, bs=16), dict(Hkv=1, G=48, d=128,
                                                    bs=16)]


def test_new_b7_shapes_are_checked(smoke):
    assert smoke.KERNEL_SHAPES[4:] == NEW_SHAPES


def _short_rows(smoke, monkeypatch, shapes):
    monkeypatch.setattr(smoke, "KERNEL_SHAPES", shapes)
    monkeypatch.setattr(smoke, "KERNEL_LENGTHS", [700, 300, 17, 1])


def test_new_b7_shapes_pass_the_split_emulation(smoke, monkeypatch, capsys):
    _short_rows(smoke, monkeypatch, NEW_SHAPES)
    _, worst_rel = smoke.phase_kernels(torch, _Ops(emulated_split_kernel),
                                       ref, torch.device("cpu"))
    out = capsys.readouterr().out
    assert out.count("  B7 float32") == out.count("  B7 bfloat16") == 24
    for shp in NEW_SHAPES:
        assert f"Hkv={shp['Hkv']} G={shp['G']} d=128" in out
    assert worst_rel <= smoke.BF16_ROW_RTOL


def _second_pass_repeats_first(q, *a, **kw):
    out = emulated_split_kernel(q, *a, **kw)
    if q.shape[2] > 8:
        out = out.clone()
        out[:, :, 8:16] = out[:, :, :8]
    return out


@pytest.mark.parametrize("shape", NEW_SHAPES[2:], ids=["G16", "G48"])
def test_a_repeated_pass_is_caught(smoke, monkeypatch, shape):
    _short_rows(smoke, monkeypatch, [shape])
    with pytest.raises(AssertionError, match="disagrees"):
        smoke.phase_kernels(torch, _Ops(_second_pass_repeats_first), ref,
                            torch.device("cpu"))


def _counting(skip_lengths=()):
    def decode_add(keep, wire, codec):
        counted = keep.shape[-1] not in skip_lengths
        if codec.name == "bf16":
            tops.BF16_LAUNCHES += counted
            return tref.decode_add_bf16(keep, wire["x"])
        tops.INT8_LAUNCHES += counted
        return tref.decode_add_int8(keep, wire["q"], wire["scale"])
    return decode_add


def test_readme_phase_counts_every_reduce_hop(smoke, monkeypatch, capsys):
    monkeypatch.setattr(collectives, "decode_add", _counting())
    cfg = get_config(ARCH)
    launches = smoke.phase_train_auto(torch, tops, tref, CODECS, cfg, None,
                                      argv=smoke.QWEN_TRAIN_ARGS)
    out = capsys.readouterr().out
    assert "[dp]" in out and "batch 8 x 32" in out
    assert out.count("through the kernels is bit-identical") == 3
    # the smoke plan: three DP buckets, each fractal + int8
    assert launches == {"bf16": 0, "int8": STEPS * 3 * 2}


def test_readme_phase_rejects_a_bucket_left_uncounted(smoke, monkeypatch):
    args = train_cli.parse_args(smoke.QWEN_TRAIN_ARGS)
    out = train_cli.run(get_config(ARCH), dict_args(args, steps=1))
    last = out["engine"].buckets[-1]
    monkeypatch.setattr(collectives, "decode_add",
                        _counting((last.length // 2, last.length // 4)))
    with pytest.raises(AssertionError, match="launches"):
        smoke.phase_train_auto(torch, tops, tref, CODECS, get_config(ARCH),
                               None, argv=smoke.QWEN_TRAIN_ARGS)


def dict_args(args, **kw):
    return type(args)(**{**vars(args), **kw})


def test_soak_phase_passes_the_port(smoke, capsys):
    res = smoke.phase_train_soak(torch, get_config(ARCH),
                                 torch.device("cpu"), TrainSoakConfig())
    assert res.ok
    out = capsys.readouterr().out
    assert "uneven shares vs even shares at width" in out
    assert "BIT-IDENTICAL" in out
    assert out.count("soak step") == len(res.history) == 25
    assert out.count("  save at step") == 6
    assert "restore of step 12" in out
    assert "first replayed loss" in out and "bit for bit" in out
    assert "exact resume" in out and "and moments BIT-IDENTICAL" in out
    assert "check_train_soak: no failure" in out


def test_soak_phase_rejects_a_lost_checkpoint(smoke, monkeypatch):
    for check in ("shares_bit_check", "exact_resume_check"):
        monkeypatch.setattr(smoke, check, lambda *a: 0)
    monkeypatch.setattr(soak_mod.CheckpointManager, "restore",
                        lambda self, like, step=None: None)
    with pytest.raises(AssertionError, match="no checkpoint to restore"):
        smoke.phase_train_soak(torch, get_config(ARCH), torch.device("cpu"),
                               TrainSoakConfig())


def test_shares_check_counts_a_partition_dependent_sum(smoke, monkeypatch,
                                                       capsys):
    def plain_add(s, e, t):
        return s + t, e

    cfg = get_config(ARCH)
    assert smoke.shares_bit_check(torch, cfg, TrainSoakConfig(),
                                  torch.device("cpu")) == 0
    monkeypatch.setattr(trainer, "_pair_add", plain_add)
    n = smoke.shares_bit_check(torch, cfg, TrainSoakConfig(),
                               torch.device("cpu"))
    assert n > 0
    assert f"DIFFER in {n} of" in capsys.readouterr().out


def test_soak_dir_needs_room(smoke, monkeypatch):
    import collections
    import shutil
    usage = collections.namedtuple("usage", "total used free")
    monkeypatch.setattr(shutil, "disk_usage", lambda p: usage(10, 9, 1))
    with pytest.raises(AssertionError, match="no room"):
        smoke._soak_dir(2)


def test_differing_bits(smoke):
    a = torch.tensor([1.0, 2.0, 3.0], dtype=torch.bfloat16)
    b = a.clone()
    assert smoke._differing_bits(torch, a, b) == (0, 0)
    b.view(torch.int16)[1] ^= 0b101
    assert smoke._differing_bits(torch, a, b) == (1, 2)
    x = torch.tensor([1.0, -0.0])
    assert smoke._differing_bits(torch, x, torch.tensor([1.0, 0.0])) == \
        (1, 1)
