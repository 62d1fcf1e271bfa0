"""``chip_smoke.py``'s slice-10 checks, run on the CPU with stand-ins.

The card's calls (``torch.cuda.synchronize``, the peak-memory gauge,
``set_sync_debug_mode``) are stubbed, the serve arguments point at the
smoke configs with ``--device cpu``, and B7's plain version counts its
calls as the kernel wrapper counts launches:

* phase [2] at Jamba's B7 decode shape (Hkv 8, G 4, d 128, shorter rows
  than on the card) passes the emulation of the split kernel of
  ``tests/test_torch_smoke_checks.py``;
* [3c]/[3w] (``phase_serve`` over the contiguous cache, ``phase_wave``):
  no paged-attention launch, and the wave oracle's first-token logits and
  outputs equal the continuous engine's in f32; a wave whose logits move
  by more than ``WAVE_LOGIT_ATOL`` is rejected;
* [8] (``phase_serve`` of Jamba, paged, one recurrent row for two slots):
  B7 counted once per attention layer per decode step, every row and
  block back in its pool; an engine that never frees its rows is
  rejected; ``phase_decode_step`` with the contiguous comparison runs
  the hybrid cache both ways, from one recurrent state;
* [3x] (``phase_recurrent_step``) profiles xlstm's decode step;
* [3s] (``phase_serve_soak``) passes a shortened soak (400 steps, the
  stall and the block window moved in) and counts B7 per decode step.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.paged_attention import ops, ref
from repro_torch.models import registry as R
from repro_torch.serve import slot_state
from test_torch_smoke_checks import _Ops, emulated_split_kernel

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SMALL = ["--device", "cpu", "--requests", "4", "--prompt-len", "12",
         "--gen", "6", "--gen-spread", "2", "--max-slots", "2",
         "--block-size", "4", "--prefill-chunk", "4", "--clock", "step"]
JAMBA_SHAPE = dict(Hkv=8, G=4, d=128, bs=16)


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


def test_jamba_b7_shape_is_checked(smoke, monkeypatch, capsys):
    assert smoke.KERNEL_SHAPES[-1] == JAMBA_SHAPE
    monkeypatch.setattr(smoke, "KERNEL_SHAPES", [JAMBA_SHAPE])
    monkeypatch.setattr(smoke, "KERNEL_LENGTHS", [700, 300, 17, 1])
    _, worst_rel = smoke.phase_kernels(torch, _Ops(emulated_split_kernel),
                                       ref, CPU)
    out = capsys.readouterr().out
    assert out.count("  B7 float32") == out.count("  B7 bfloat16") == 6
    assert "Hkv=8 G=4 d=128" in out
    assert worst_rel <= smoke.BF16_ROW_RTOL


def test_published_sizes(smoke):
    jamba = smoke.jamba_config()
    assert jamba.num_layers == 16 and jamba.layer_pattern == \
        R.get_config("jamba-v0.1-52b").layer_pattern[:16]
    assert R.count_params(jamba) == 26_053_595_136
    assert R.count_params(R.get_config("xlstm-1.3b")) == 2_020_763_984
    assert smoke._kernel_layers(jamba) == (2, 0)
    assert "contiguous" in smoke.CONTIG_SERVE_ARGS
    assert "paged" not in smoke.CONTIG_SERVE_ARGS


def test_contiguous_serve_and_wave(smoke, capsys):
    cfg = R.get_config("gemma2-2b-smoke")
    argv = ["--arch", cfg.name] + SMALL
    cont = {}
    assert smoke.phase_serve(torch, ops, cfg, argv, out=cont) == (0, 0)
    assert len(cont["first"]) == 4
    assert smoke.phase_wave(torch, ops, cfg, argv, cont,
                            smoke.WAVE_LOGIT_ATOL) == 1.0
    out = capsys.readouterr().out
    assert "(continuous, contiguous cache): 4/4 completed" in out
    assert "outputs token-identical for 4/4" in out


def test_wave_logits_off_are_rejected(smoke, monkeypatch):
    from repro_torch.models import transformer as T
    cfg = R.get_config("gemma2-2b-smoke")
    argv = ["--arch", cfg.name] + SMALL
    cont = {}
    smoke.phase_serve(torch, ops, cfg, argv, out=cont)
    prefill = T.prefill

    def off(*a, **k):
        lg, cache, n = prefill(*a, **k)
        return lg + 2 * smoke.WAVE_LOGIT_ATOL, cache, n

    monkeypatch.setattr(T, "prefill", off)
    with pytest.raises(AssertionError, match="wave first-token logits"):
        smoke.phase_wave(torch, ops, cfg, argv, cont, smoke.WAVE_LOGIT_ATOL)


def test_jamba_paged_serve_counts_and_drains(smoke, capsys):
    cfg = R.get_config("jamba-v0.1-52b-smoke")
    argv = ["--arch", cfg.name] + SMALL + ["--kv-mode", "paged",
                                           "--rec-slots", "1"]
    launches, merges = smoke.phase_serve(torch, ops, cfg, argv)
    out = capsys.readouterr().out
    assert launches == merges > 0
    assert f"{launches} paged_attention launches" in out
    assert "every recurrent row and block back in its pool" in out
    assert "1×paged + 7×recurrent (1 recurrent rows)" in out


def test_leaked_rows_are_rejected(smoke, monkeypatch):
    """Rows that are never handed back (with a row for every request, so
    the run still drains)."""
    monkeypatch.setattr(slot_state.RecurrentRows, "free",
                        lambda self, row: None)
    cfg = R.get_config("jamba-v0.1-52b-smoke")
    with pytest.raises(AssertionError, match="still in use"):
        smoke.phase_serve(torch, ops, cfg, ["--arch", cfg.name] + SMALL
                          + ["--rec-slots", "8"])


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b-smoke",
                                  "deepseek-v3-671b-smoke"])
def test_decode_step_paged_and_contiguous(smoke, capsys, arch):
    cfg = R.get_config(arch)
    smoke.phase_decode_step(torch, cfg, CPU, 1e-4, contiguous=1e-4)
    out = capsys.readouterr().out
    assert "over the contiguous cache: max|logits(contiguous)" in out
    assert "0 synchronising calls" in out


def test_recurrent_step(smoke, capsys):
    smoke.phase_recurrent_step(torch, R.get_config("xlstm-1.3b-smoke"), CPU)
    out = capsys.readouterr().out
    assert "prefill of 7 x 256 tokens" in out and "idles" in out


def test_serve_soak_phase(smoke, monkeypatch, capsys):
    monkeypatch.setattr(smoke, "SERVE_SOAK_STEPS", 400)
    monkeypatch.setattr(smoke, "SERVE_SOAK_PLAN",
                        "stall:steps=150..190;blocks:frac=0.5,steps=220..260")
    cfg = R.get_config("gemma2-2b-smoke")
    launches = smoke.phase_serve_soak(torch, ops, cfg, CPU)
    out = capsys.readouterr().out
    assert "failures []" in out and launches > 0
