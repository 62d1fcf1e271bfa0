"""``chip_smoke.py``'s slice-12 checks, run on the CPU at smoke size.

* [5i]/[5j] (``phase_train_frontend``, here at paligemma-3b-smoke and
  musicgen-medium-smoke on the CPU with a decode-add that counts like the
  kernel wrappers): every frontend batch trains, every bucket's int8 hops
  are counted, steps x buckets x log2(4), and every bucket's real
  gradients (of frontend batches) reduce-scatter through the counted path
  and the plain versions alike; a wrapper that misses one bucket is
  rejected;
* [3p]/[3m] (``phase_frontend_decode``): prefill + greedy decode against
  ``forward`` passes for both (f32 reads ~1e-6 of the row RMS); a decode
  that drops musicgen's positions at the decode offsets, and a model that
  loses paligemma's bidirectional prefix, are rejected;
* [5k] (``phase_calibrate``, world 4 on the CPU): the fit over the
  reference's grid, the two plans, ``--calibrate`` and its resume with the
  decode-add launches counted, and every codec bucket of the calibrated
  plan held to the plain versions on real gradients; a resume that refits
  instead of reloading, and an int8 decode-add that rounds its product
  before the add (on a link fitted to fake timings, whose plan puts int8
  on a bucket), are rejected.

The ``cuda``-marked tests run the phases at smoke size on the card and
skip here.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.core import collectives
from repro_torch.kernels.tree_reduce import ops as tops, ref as tref
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as T
from repro_torch.models.registry import count_params, get_config
from repro_torch.optim.compression import Bf16Codec, Int8Codec
from test_torch_smoke_schedule_checks import _two_roundings
from test_torch_smoke_slice9_checks import _counting

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
PALI, MUSICGEN = "paligemma-3b-smoke", "musicgen-medium-smoke"
STEPS = 2
CODECS = {"bf16": Bf16Codec(), "int8": Int8Codec()}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def train_args(arch, device="cpu"):
    return ["--arch", arch, "--device", device, "--devices", "4", "--steps",
            str(STEPS), "--batch", "8", "--seq", "16", "--lr", "3e-4",
            "--seed", "0", "--schedule", "auto", "--bucket-mb", "auto",
            "--bucket-codec", "auto"]


def cal_args(device="cpu"):
    return ["--arch", MUSICGEN, "--device", device, "--devices", "4",
            "--batch", "8", "--seq", "16", "--lr", "3e-4", "--seed", "0",
            "--calibrate", "--schedule", "auto", "--bucket-mb", "auto",
            "--bucket-codec", "auto"]


def test_published_sizes(smoke):
    from repro_torch.models import layers as L
    pali = smoke.cut_config("paligemma-3b", smoke.PALI_TRAIN_CUT)
    assert count_params(pali) == 1_189_767_168
    assert 42 * count_params(pali) / 1e9 == pytest.approx(50.0, abs=0.05)
    mg = smoke.cut_config("musicgen-medium", smoke.MUSICGEN_TRAIN_CUT)
    assert mg.num_layers == 48 and count_params(mg) == 1_366_574_592
    assert count_params(smoke.cut_config(
        "musicgen-medium", smoke.CAL_TRAIN_CUT)) == 64_101_888
    args = train_cli.parse_args(smoke.PALI_TRAIN_ARGS)
    assert pali.frontend_tokens + args.seq == L.QUERY_CHUNK_THRESHOLD
    assert (args.batch, args.steps, args.devices) == (8, 3, 4)
    args = train_cli.parse_args(smoke.MUSICGEN_TRAIN_ARGS)
    assert (args.batch, args.seq, args.steps) == (8, 1024, 3)
    assert train_cli.parse_args(smoke.CAL_TRAIN_ARGS).calibrate
    assert smoke.FRONTEND_DECODE == dict(rows=8, prompt=64, steps=32)


@pytest.mark.parametrize("arch", [PALI, MUSICGEN])
def test_train_phase_counts_every_reduce_hop(smoke, monkeypatch, capsys,
                                             arch):
    monkeypatch.setattr(collectives, "decode_add", _counting())
    launches = smoke.phase_train_frontend(torch, tops, tref, CODECS,
                                          get_config(arch), train_args(arch))
    out = capsys.readouterr().out
    n = out.count("through the kernels is bit-identical")
    assert n >= 1 and launches == {"bf16": 0, "int8": STEPS * n * 2}
    assert "frontend-stub embeddings + 16 text tokens" in out
    assert f"auto step {STEPS - 1}: loss" in out


def test_train_phase_rejects_a_bucket_left_uncounted(smoke, monkeypatch):
    args = train_cli.parse_args(train_args(PALI))
    eng = train_cli.run(get_config(PALI),
                        type(args)(**{**vars(args), "steps": 1}))["engine"]
    last = eng.buckets[-1]
    monkeypatch.setattr(collectives, "decode_add",
                        _counting((last.length // 2, last.length // 4)))
    with pytest.raises(AssertionError, match="launches"):
        smoke.phase_train_frontend(torch, tops, tref, CODECS,
                                   get_config(PALI), train_args(PALI))


@pytest.mark.parametrize("arch", [PALI, MUSICGEN])
def test_decode_phase_passes_the_port(smoke, capsys, arch):
    worst = smoke.phase_frontend_decode(torch, get_config(arch), CPU)
    out = capsys.readouterr().out
    assert worst < 1e-4
    kind = "bidirectional" if "pali" in arch else "causal"
    assert f"{kind} prefix" in out and "argmax agreement 100.0%" in out
    assert "offset 72 = 8 + 64" in out


def test_decode_phase_rejects_lost_decode_positions(smoke, monkeypatch):
    """A decode whose sinusoid ignores the step's offset (position 0
    instead) is caught against ``forward``."""
    embed = T._embed

    def at_zero(params, cfg, tokens, frontend_embeds=None, positions=None):
        if positions is not None:
            positions = torch.zeros_like(positions)
        return embed(params, cfg, tokens, frontend_embeds, positions)

    monkeypatch.setattr(T, "_embed", at_zero)
    with pytest.raises(AssertionError, match="row RMS"):
        smoke.phase_frontend_decode(torch, get_config(MUSICGEN), CPU)


def test_decode_phase_rejects_a_causal_prefix_lm(smoke, monkeypatch):
    monkeypatch.setattr(T, "_prefix_len", lambda cfg: None)
    with pytest.raises(AssertionError, match="prefix"):
        smoke.phase_frontend_decode(torch, get_config(PALI), CPU)


def test_calibrate_phase_fits_persists_and_reloads(smoke, monkeypatch,
                                                   capsys):
    monkeypatch.setattr(collectives, "decode_add", _counting())
    launches = smoke.phase_calibrate(torch, tops, tref, CODECS,
                                     get_config(MUSICGEN), CPU,
                                     argv=cal_args())
    out = capsys.readouterr().out
    assert "fitted fitted-cpu4: alpha=" in out
    assert "at the fit's clamp of 1e-12" in out
    assert out.count("priced with v5e-ici") == 2
    assert out.count("priced with fitted-cpu4") == 2
    assert "calibrate: reloaded fitted-cpu4 from" in out
    assert launches["bf16"] % 2 == 0 and launches["int8"] % 2 == 0
    # 2 runs x 2 hops a codec bucket, each bucket held once bit for bit
    held = out.count("through the kernels is bit-identical")
    assert 4 * held == launches["bf16"] + launches["int8"]
    assert held or "no bucket to hold" in out


def _fake_link(monkeypatch, slow=None):
    """Calibrate on fake timings: 1 us a launch plus 16 GB/s of payload,
    so the fit (and the plan it prices) is the same on every run; each
    time is scaled by ``slow["by"]`` (default 1)."""
    from repro_torch.core import calibrate as CAL
    slow = {"by": 1.0} if slow is None else slow

    def measure(shape, schedule, per_rank_elems, **kw):
        return slow["by"] * (1e-6 * (1 + len(schedule))
                             + 4 * per_rank_elems / 16e9)
    monkeypatch.setattr(CAL, "_measure_collective", measure)


def test_calibrate_phase_holds_the_fitted_plans_buckets(smoke, monkeypatch,
                                                        capsys):
    _fake_link(monkeypatch)
    monkeypatch.setattr(collectives, "decode_add", _counting())
    launches = smoke.phase_calibrate(torch, tops, tref, CODECS,
                                     get_config(MUSICGEN), CPU,
                                     argv=cal_args())
    out = capsys.readouterr().out
    held = out.count("through the kernels is bit-identical")
    assert launches["int8"] > 0
    assert 4 * held == launches["bf16"] + launches["int8"]


def test_calibrate_phase_rejects_a_two_rounding_int8_add(smoke,
                                                         monkeypatch):
    """The training runs count right, but the real-bucket check between
    them catches an int8 decode-add that rounds q x scale before the add."""
    _fake_link(monkeypatch)
    count = _counting()

    def two_roundings(keep, wire, codec):
        out = count(keep, wire, codec)
        if codec.name == "int8":
            return _two_roundings(keep, wire["q"], wire["scale"])
        return out
    monkeypatch.setattr(collectives, "decode_add", two_roundings)
    with pytest.raises(AssertionError, match="real-bucket reduce-scatter"):
        smoke.phase_calibrate(torch, tops, tref, CODECS,
                              get_config(MUSICGEN), CPU, argv=cal_args())


def test_calibrate_phase_rejects_a_refit_on_resume(smoke, monkeypatch):
    """A resume that fits the link anew instead of reloading the persisted
    one is rejected.  The timings are fake and the refit's 1 % slower, so
    the plan stays and the resume itself succeeds (a refit that moves the
    plan fails the checkpoint's layout check already)."""
    slow = {"by": 1.0}
    _fake_link(monkeypatch, slow)
    monkeypatch.setattr(collectives, "decode_add", _counting())
    real = train_cli.calibrated_link

    def refit(args, dev, world):
        if args.checkpoint_dir:
            path = Path(args.checkpoint_dir) / train_cli.CALIBRATION_FILE
            if path.exists():
                path.unlink()
                slow["by"] = 1.01
        return real(args, dev, world)

    monkeypatch.setattr(train_cli, "calibrated_link", refit)
    with pytest.raises(AssertionError, match="calibrate run 2"):
        smoke.phase_calibrate(torch, tops, tref, CODECS,
                              get_config(MUSICGEN), CPU, argv=cal_args())


@pytest.mark.cuda
@pytest.mark.parametrize("phase", ["5i", "5j", "3p", "3m", "5k"])
def test_phases_on_the_card(smoke, phase):
    """The five phases at smoke size on the card: B2 counted by its
    wrapper on the train paths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card via chip_smoke / "
                    "pytest -m cuda)")
    dev = torch.device("cuda", 0)
    if phase in ("5i", "5j"):
        arch = PALI if phase == "5i" else MUSICGEN
        launches = smoke.phase_train_frontend(
            torch, tops, tref, CODECS, get_config(arch),
            train_args(arch, "cuda"))
        assert launches["int8"] > 0
    elif phase in ("3p", "3m"):
        smoke.phase_frontend_decode(
            torch, get_config(PALI if phase == "3p" else MUSICGEN), dev)
    else:
        smoke.phase_calibrate(torch, tops, tref, CODECS,
                              get_config(MUSICGEN), dev,
                              argv=cal_args("cuda"))
