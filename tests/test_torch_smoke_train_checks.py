"""``chip_smoke.py``'s codec and train checks, run on the CPU.

The decode-add kernels (B1, B2) cannot run here, so their plain versions
stand in for them: ``phase_codec_kernels`` must pass them, bit for bit on
every case, and must reject an int8 kernel that rounds the product before
the add (the reference contracts it into one FMA).  The train phase runs
at smoke size on the CPU with a decode-add that counts like the kernel
wrappers: each codec's count must equal steps x buckets x log2(world),
which the phase asserts.
"""

import importlib.util
import types
from pathlib import Path

import pytest
import torch

from repro_torch.core import collectives
from repro_torch.kernels.tree_reduce import ops as tops, ref as tref
from repro_torch.models.registry import get_config
from repro_torch.optim.compression import Bf16Codec, Int8Codec

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CODECS = {"bf16": Bf16Codec(), "int8": Int8Codec()}


def _two_roundings(keep, q, scale):
    prod = q.float().view(-1, 128) * scale.view(-1, 1)
    return keep + prod.view(keep.shape)


@pytest.fixture
def no_sync(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)


def test_codec_check_passes_the_plain_versions(smoke, no_sync, capsys):
    stand_in = types.SimpleNamespace(
        decode_add_bf16_kernel=tref.decode_add_bf16,
        decode_add_int8_kernel=tref.decode_add_int8)
    worst = smoke.phase_codec_kernels(torch, stand_in, tref, CODECS,
                                      torch.device("cpu"))
    assert worst == {"bf16": 0.0, "int8": 0.0}
    out = capsys.readouterr().out
    assert out.count("bit-identical") == 2 * (len(smoke.CODEC_BF16_MS)
                                              + len(smoke.CODEC_INT8_NBS))


def test_codec_check_rejects_two_roundings(smoke, no_sync):
    stand_in = types.SimpleNamespace(
        decode_add_bf16_kernel=tref.decode_add_bf16,
        decode_add_int8_kernel=_two_roundings)
    with pytest.raises(AssertionError, match="int8"):
        smoke.phase_codec_kernels(torch, stand_in, tref, CODECS,
                                  torch.device("cpu"))


def test_train_phase_counts_every_reduce_hop(smoke, no_sync, monkeypatch,
                                            capsys):
    def counting(keep, wire, codec):
        if codec.name == "bf16":
            tops.BF16_LAUNCHES += 1
            return tref.decode_add_bf16(keep, wire["x"])
        tops.INT8_LAUNCHES += 1
        return tref.decode_add_int8(keep, wire["q"], wire["scale"])

    monkeypatch.setattr(collectives, "decode_add", counting)
    monkeypatch.setattr(smoke, "TRAIN_ARGS", [
        "--arch", "gemma2-2b-smoke", "--device", "cpu", "--devices", "4",
        "--steps", str(smoke.TRAIN_STEPS), "--batch", "8", "--seq", "32",
        "--schedule", "fractal", "--bucket-mb", "0.25", "--seed", "0"])
    cfg = get_config("gemma2-2b-smoke")
    launches = smoke.phase_train(torch, tops, cfg)
    n_b = smoke.train_engine(cfg, "int8").n_buckets
    assert n_b > 1
    assert launches == {"bf16": 3 * n_b * 2, "int8": 3 * n_b * 2}
    assert "decode_add_int8 launches" in capsys.readouterr().out
