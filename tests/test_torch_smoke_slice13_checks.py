"""``chip_smoke.py``'s slice-13 checks, run on the CPU at smoke size.

The card's calls (``torch.cuda.synchronize``, the peak-memory gauge) are
stubbed and the arguments point at the smoke configs with ``--device
cpu``; B7's plain version counts its calls as the kernel wrapper counts
launches:

* [5l] (``phase_gspmd_train``): ``--schedule xla`` trains through the CLI
  and its step-0 loss at the cut equals the fractal step-0 loss of the
  same params and batch (f32: within 1e-5 here); a fractal loss off by
  more than ``GSPMD_LOSS_ATOL`` is rejected;
* [5m] (``phase_tier_equivalence``): Tier A and Tier B agree within the
  stated bounds (f32, gaps far below them); a Tier A whose update lands
  10·lr off is rejected;
* [4m] (``phase_mesh_serve``, ``phase_mesh_decode``): ``--devices 4``
  serves token-identically to the unsharded runs with their B7 launches,
  and the slot pool of 6 raises the reference's error; an earlier run
  with another output or another launch count is rejected; the decode
  step is profiled without and with the serving policy, whose hooks are
  counted.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.paged_attention import ops, ref
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import act_sharding as ACT
from repro_torch.models import registry as R
from repro_torch.optim import adamw

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
GEMMA = "gemma2-2b-smoke"
SERVE = ["--arch", GEMMA, "--device", "cpu", "--requests", "6",
         "--prompt-len", "12", "--gen", "6", "--gen-spread", "2",
         "--max-slots", "4", "--block-size", "4", "--prefill-chunk", "4",
         "--clock", "step"]
TRAIN = ["--arch", GEMMA, "--device", "cpu", "--devices", "4", "--steps",
         "2", "--batch", "8", "--seq", "16", "--lr", "3e-4", "--seed", "0"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    ACT.clear_policy()


@pytest.fixture
def smoke(monkeypatch):
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name in ("synchronize", "reset_peak_memory_stats",
                 "set_sync_debug_mode"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: 0)

    def counted(*a, **k):               # the wrapper's count, on the CPU
        ops.LAUNCHES += 1
        ops.MERGE_LAUNCHES += 1
        return ref.paged_attention_ref(*a, **k)

    monkeypatch.setattr(ops, "paged_attention_ref", counted)
    return mod


def test_published_sizes(smoke):
    gemma = R.get_config("gemma2-2b")
    n = R.count_params(gemma)
    assert gemma.num_layers == 26 and n == 2_614_341_888
    acfg = adamw.AdamWConfig()
    assert adamw.optimizer_bytes_per_param(acfg) == 12
    assert 12 * n / 1e9 == pytest.approx(31.37, abs=0.01)
    args = train_cli.parse_args(smoke.GSPMD_ARGS)
    base = train_cli.parse_args(smoke.TRAIN_ARGS)
    assert (args.schedule, args.devices, args.steps) == ("xla", 4, 3)
    assert (args.batch, args.seq, args.lr, args.seed) == \
        (base.batch, base.seq, base.lr, base.seed)
    eq = smoke.train_config(smoke.EQUIV_CUT)
    assert eq.num_layers == 2 and R.count_params(eq) == 745_558_272
    assert smoke.EQUIV_LOSS_ATOL[0] == smoke.GSPMD_LOSS_ATOL
    slots = serve_cli.parse_args(smoke.SERVE_ARGS).max_slots
    assert slots % smoke.MESH_DEVICES == 0 and smoke.MESH_DEVICES == 4


def test_bf16_ulp(smoke):
    x = torch.tensor([1.0, 1.5, 0.75, -3.0, 2.0 ** -10])
    want = torch.tensor([2.0 ** -7, 2.0 ** -7, 2.0 ** -8, 2.0 ** -6,
                         2.0 ** -17])
    assert torch.equal(smoke._bf16_ulp(torch, x), want)
    # the next bf16 value is one ulp away
    y = torch.tensor([1.0, 0.75, 3.0]).bfloat16()
    step = smoke._bf16_ulp(torch, y.float())
    assert torch.equal((y.float() + step).bfloat16().float() - y.float(),
                       step)


def _fractal_loss0(cfg):
    args = train_cli.parse_args(TRAIN + ["--schedule", "fractal", "--steps",
                                         "1"])
    return train_cli.run(cfg, args)["history"][0]["loss"]


def test_gspmd_phase_trains_and_matches_the_fractal_loss(smoke, capsys):
    cfg = R.get_config(GEMMA)
    first = _fractal_loss0(cfg)
    secs, loss0 = smoke.phase_gspmd_train(
        torch, cfg, cfg, first, TRAIN + ["--schedule", "xla"])
    out = capsys.readouterr().out
    assert abs(loss0 - first) <= 1e-5 and len(secs) == 1
    assert "gspmd step 1: loss" in out and "(bf16 bound 0.02)" in out
    assert "gspmd: mesh data=4 × model=1" in out
    assert "12 B a parameter" in out


def test_gspmd_phase_rejects_another_loss(smoke):
    cfg = R.get_config(GEMMA)
    first = _fractal_loss0(cfg)
    with pytest.raises(AssertionError, match="gspmd step-0 loss"):
        smoke.phase_gspmd_train(torch, cfg, cfg,
                                first + 2 * smoke.GSPMD_LOSS_ATOL,
                                TRAIN + ["--schedule", "xla"])


def test_tier_equivalence_phase(smoke, capsys):
    worst = smoke.phase_tier_equivalence(torch, R.get_config(GEMMA), CPU,
                                         TRAIN)
    out = capsys.readouterr().out
    assert worst < 0.5
    assert "step 1: loss xla" in out and "largest gap / its bound" in out


def test_tier_equivalence_rejects_an_update_off_by_10_lr(smoke,
                                                        monkeypatch):
    update = adamw._update

    def off(p, g, m, n, scale, lr, bc1, bc2, cfg):
        update(p, g, m, n, scale, lr, bc1, bc2, cfg)
        p.add_(10 * cfg.lr)

    monkeypatch.setattr(adamw, "_update", off)
    with pytest.raises(AssertionError, match="its bound"):
        smoke.phase_tier_equivalence(torch, R.get_config(GEMMA), CPU, TRAIN)


def _earlier(smoke, cfg, argv):
    out = {}
    counts = smoke.phase_serve(torch, ops, cfg, argv, out=out)
    return out, counts


@pytest.mark.parametrize("kv", ["paged", "contiguous"])
def test_mesh_serve_phase(smoke, capsys, kv):
    cfg = R.get_config(GEMMA)
    argv = SERVE + ["--kv-mode", kv]
    out, counts = _earlier(smoke, cfg, argv)
    assert (counts[0] > 0) == (kv == "paged")
    got = smoke.phase_mesh_serve(torch, ops, cfg, [(argv, out, counts)])
    text = capsys.readouterr().out
    assert got == [counts]
    assert "token-identical to the unsharded run's for 6/6" in text
    assert "devices=4" in text
    assert "ValueError '--max-slots 6 must divide across 4 devices'" in text


def test_mesh_serve_phase_rejects_other_outputs_or_launches(smoke):
    cfg = R.get_config(GEMMA)
    argv = SERVE + ["--kv-mode", "paged"]
    out, counts = _earlier(smoke, cfg, argv)
    with pytest.raises(AssertionError, match="launches"):
        smoke.phase_mesh_serve(torch, ops, cfg,
                               [(argv, out, (counts[0] + 1, counts[1]))])
    first = min(out["results"])
    out["results"][first] = out["results"][first][:-1] + [-1]
    with pytest.raises(AssertionError, match="token-identical"):
        smoke.phase_mesh_serve(torch, ops, cfg, [(argv, out, counts)])


def test_mesh_decode_phase(smoke, capsys):
    cfg = R.get_config(GEMMA)
    (ms0, busy0), (ms1, busy1) = smoke.phase_mesh_decode(torch, cfg, CPU,
                                                         calls=1000)
    out = capsys.readouterr().out
    # gemma2-2b-smoke: the embedding, each of its units, the logits
    units = sum(reps for _, reps in cfg.segments())
    assert f"act hooks: {units + 2} calls a decode step" in out
    assert "decode step with no activation policy" in out
    assert "decode step with the activation policy" in out
    assert ms0 > 0 and ms1 > 0 and ACT._POLICY is None
