"""``chip_smoke.py``'s slice-14 checks (phase [9], the dry run), run on the
CPU at smoke size.

The card's calls (``torch.cuda.synchronize``, the peak-memory gauge) are
stubbed and the arguments point at gemma2-2b-smoke with ``--device cpu``;
on the CPU the "card" step is a CPU step, whose counted peak of live
storage stands in for the allocator's:

* [9a] (``phase_dryrun_cli``): the CLI, one process a cell, writes an
  ``ok`` record for each cell on both meshes under ``build/dryrun``; a cell
  the CLI cannot trace is rejected;
* [9b] (``phase_dryrun_card``): the meta trace and the counted step agree
  on FLOPs, dots, argument bytes and the peak of live storage under block
  and dots remat, dots' step-0 loss equals block's and its params are
  within phase 5m's bound; a step that runs other work than it traces, and
  a dots step whose loss moves, are rejected.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.launch import dryrun as DR
from repro_torch.models import act_sharding as ACT
from repro_torch.models import registry as R
from repro_torch.models import transformer as T
from repro_torch.runtime import trainer

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
GEMMA = "gemma2-2b-smoke"
ARGS = ["--arch", GEMMA, "--device", "cpu", "--devices", "4", "--steps",
        "3", "--batch", "8", "--seq", "16", "--schedule", "xla", "--lr",
        "3e-4", "--seed", "0"]
TAG = "slice14_rehearsal"


@pytest.fixture(scope="module", autouse=True)
def _restore():
    yield
    T.set_remat("block")
    ACT.clear_policy()


@pytest.fixture
def smoke(monkeypatch):
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(mod, "_smi", lambda: "cpu (no card)")
    return mod


def test_published_sizes(smoke):
    assert smoke.DRYRUN_CELLS == ("gemma2-2b:train_4k",
                                  "deepseek-v3-671b:decode_32k",
                                  "xlstm-1.3b:long_500k")
    assert smoke.DRYRUN_REMATS == ("block", "dots")
    assert 0 < smoke.DRYRUN_PEAK_RTOL <= 0.05
    from repro_torch.launch import train as train_cli
    args = train_cli.parse_args(smoke.GSPMD_ARGS)
    assert (args.devices, args.batch, args.seq) == (4, 8, 1024)


def test_dryrun_cli_phase_writes_ok_records(smoke, capsys):
    cells = ("gemma2-2b-smoke:train_4k", "xlstm-1.3b-smoke:long_500k")
    recs = smoke.phase_dryrun_cli(torch, cells=cells, tag=TAG)
    assert [(r["arch"], r["shape"], r["mesh"]) for r in recs] == [
        (a, s, m) for a, _, s in (c.partition(":") for c in cells)
        for m in ("single", "multi")]
    assert all(r["status"] == "ok" for r in recs)
    for r in recs:
        path = DR.cell_path(r["arch"], r["shape"], r["mesh"], TAG)
        assert path.is_relative_to(ROOT / "build")
    out = capsys.readouterr().out
    assert out.count("9a ") == 4 and "roofline on h100-sxm" in out


def test_dryrun_cli_phase_rejects_a_failed_cell(smoke):
    with pytest.raises(AssertionError, match="exit 1"):
        smoke.phase_dryrun_cli(torch, cells=("gemma2-2b-smoke:no_such",),
                               tag=TAG)


def test_dryrun_card_phase_on_cpu(smoke, capsys):
    cfg = R.get_config(GEMMA)
    out = smoke.phase_dryrun_card(torch, cfg, CPU, ARGS)
    assert set(out) == {"block", "dots"}
    assert out["dots"]["loss0"] == out["block"]["loss0"]
    assert out["dots"]["flops"] < out["block"]["flops"]
    assert out["dots"]["traced_peak"] == out["dots"]["peak"]
    assert all(0 < r["floor_s"] < r["eager_traffic_s"] for r in out.values())
    text = capsys.readouterr().out
    assert "9b dots vs block: step-0 loss bit for bit" in text
    assert text.count("the H100 SXM floor") == 2 and "no bound" in text
    assert T._REMAT == "block" and ACT._POLICY is None


def test_dryrun_card_phase_rejects_other_work_than_traced(smoke,
                                                          monkeypatch):
    make = trainer.make_gspmd_train_step

    def extra_matmul(cfg, mesh, acfg):
        step, specs = make(cfg, mesh, acfg)

        def run(state, batch):
            if mesh.device.type != "meta":
                w = state.params["embed"]
                (w.detach()[:4] @ w.detach()[:4].T).sum()
            return step(state, batch)
        return run, specs

    monkeypatch.setattr(trainer, "make_gspmd_train_step", extra_matmul)
    with pytest.raises(AssertionError, match="traced FLOPs"):
        smoke.phase_dryrun_card(torch, R.get_config(GEMMA), CPU, ARGS)


def test_dryrun_card_phase_rejects_a_dots_loss_that_moves(smoke,
                                                          monkeypatch):
    make = trainer.make_gspmd_train_step

    def nudged(cfg, mesh, acfg):
        step, specs = make(cfg, mesh, acfg)

        def run(state, batch):
            if T._REMAT == "dots" and mesh.device.type != "meta":
                with torch.no_grad():
                    state.params["final_norm"]["scale"].add_(1e-3)
            return step(state, batch)
        return run, specs

    monkeypatch.setattr(trainer, "make_gspmd_train_step", nudged)
    with pytest.raises(AssertionError, match="step-0 loss dots"):
        smoke.phase_dryrun_card(torch, R.get_config(GEMMA), CPU, ARGS)
