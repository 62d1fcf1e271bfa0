"""Port parity: the timed half of ``core/calibrate.py`` and the train CLI's
``--calibrate``, on the CPU (world 4, the ranks stacked on one device).

  * ``fit_link_params``'s grid against the reference's: with both
    packages' ``_measure_collective`` replaced by one deterministic fake
    (the reference's needs a device per rank), the samples (schedule,
    mesh, payload bytes, seconds) come in the reference's order, each
    payload rounded up to a multiple of the world, and the fits are equal,
    the name ``fitted-cpu4`` included;
  * the real timing on the CPU: one sample per (schedule, payload), each
    a positive time, and a finite fit; ``_measure_collective``'s first
    call runs outside the timing; ``min_devices`` raises ``ValueError``
    as the reference's does;
  * ``python -m repro_torch.core.calibrate --links`` needs a world of 8,
    as the reference's, and writes its link-calibration JSON;
  * ``launch.train --calibrate --device cpu --devices 4 --checkpoint-dir
    d`` writes ``{"link": asdict(link)}`` to ``d/link_calibration.json``,
    prices its plan with the fitted link, and a second run (a resume)
    prints ``calibrate: reloaded`` and the same plan; a file written by
    the reference's ``LinkParams`` loads; a world of 1 prints the
    reference's skip line.
"""

import dataclasses
import json
import math

import numpy as np
import pytest

from repro.core import calibrate as JCAL
from repro.core.cost_model import LinkParams as JLinkParams
from repro_torch.core import calibrate as CAL
from repro_torch.core import collectives as C
from repro_torch.launch import train as train_cli

WORLD = 4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The timed all-reduces are many small ops, which a thread pool per
    worker only slows when the suite's workers share the cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fake_seconds(schedule, per_rank):
    """A deterministic stand-in for a timed all-reduce."""
    base = {"fractal": 2e-6, "ring": 5e-6, "tree": 3e-6}[schedule]
    return base + per_rank * 4.0 / 5e9


def test_grid_and_fit_match_reference(monkeypatch):
    import repro.compat as jcompat
    import jax

    got_calls, want_calls = [], []

    def ours(shape, schedule, per_rank, repeats=3, inner=5, device="cuda"):
        got_calls.append((tuple(shape), schedule, per_rank, repeats))
        return _fake_seconds(schedule, per_rank)

    def theirs(mesh, axis_names, sizes, schedule, per_rank, repeats=3,
               inner=5):
        want_calls.append((tuple(sizes), schedule, per_rank, repeats))
        return _fake_seconds(schedule, per_rank)

    monkeypatch.setattr(CAL, "_measure_collective", ours)
    monkeypatch.setattr(JCAL, "_measure_collective", theirs)
    monkeypatch.setattr(jcompat, "make_mesh", lambda *a, **k: None)
    monkeypatch.setattr(jax, "devices", lambda *a: [jax.local_devices()[0]]
                        * WORLD)
    fit = CAL.fit_link_params(WORLD, min_devices=2, device="cpu")
    jfit = JCAL.fit_link_params((WORLD,), min_devices=2)
    assert got_calls == want_calls
    assert len(got_calls) == len(JCAL.FIT_SCHEDULES) * len(
        JCAL.FIT_PAYLOAD_ELEMS)
    assert [c[1] for c in got_calls[:len(JCAL.FIT_PAYLOAD_ELEMS)]] == \
        ["fractal"] * len(JCAL.FIT_PAYLOAD_ELEMS)         # schedule-major
    assert all(c[2] % WORLD == 0 for c in got_calls)
    assert [dataclasses.astuple(s) for s in fit.samples] == \
        [dataclasses.astuple(s) for s in jfit.samples]
    assert dataclasses.asdict(fit.link) == dataclasses.asdict(jfit.link)
    assert fit.link.name == "fitted-cpu4"
    assert fit.residual == jfit.residual
    assert fit.describe() == jfit.describe()
    assert CAL.FIT_SCHEDULES == JCAL.FIT_SCHEDULES
    assert CAL.FIT_PAYLOAD_ELEMS == JCAL.FIT_PAYLOAD_ELEMS


def test_timed_fit_on_the_cpu():
    fit = CAL.fit_link_params(WORLD, payload_elems=(1 << 10, 1 << 14),
                              repeats=1, min_devices=2, device="cpu")
    assert [(s.schedule, s.shape, s.payload_bytes) for s in fit.samples] == \
        [(sch, (WORLD,), n * 4.0) for sch in CAL.FIT_SCHEDULES
         for n in (1 << 10, 1 << 14)]
    assert all(s.seconds > 0 for s in fit.samples)
    lk = fit.link
    assert all(math.isfinite(v) and v > 0 for v in
               (lk.alpha_s, lk.bw_Bps, lk.hop))
    assert math.isfinite(fit.residual)


def test_measure_collective_warms_then_times(monkeypatch):
    calls = []
    real = C.all_reduce

    def counted(x, schedule, shape=None):
        calls.append((tuple(x.shape), x.dtype, schedule, tuple(shape)))
        return real(x, schedule, shape)

    monkeypatch.setattr(C, "all_reduce", counted)
    secs = CAL._measure_collective((WORLD,), "ring", 64, repeats=2, inner=3,
                                   device="cpu")
    assert secs > 0
    assert len(calls) == 1 + 2 * 3
    import torch
    assert set(calls) == {((WORLD, 64), torch.float32, "ring", (WORLD,))}


def test_min_devices_raises_as_the_reference():
    with pytest.raises(ValueError, match="link calibration needs ≥8"):
        CAL.fit_link_params(WORLD, device="cpu")
    with pytest.raises(ValueError, match="link calibration needs ≥8"):
        JCAL.fit_link_params(min_devices=8)


def test_links_cli_writes_the_reference_format(tmp_path, capsys):
    out = tmp_path / "link.json"
    with pytest.raises(ValueError, match="needs ≥8"):    # as the reference
        CAL.main(["--links", "--devices", str(WORLD), "--device", "cpu"])
    CAL.main(["--links", "--devices", "8", "--device", "cpu", "--out",
              str(out)])
    data = json.loads(out.read_text())
    assert sorted(data) == ["link", "residual", "samples"]
    assert JLinkParams(**data["link"]).name == "fitted-cpu8"
    assert len(data["samples"]) == 12
    assert sorted(data["samples"][0]) == ["payload_bytes", "schedule",
                                          "seconds", "shape"]
    assert "fitted fitted-cpu8: alpha=" in capsys.readouterr().out


def _train(ckpt, steps, capsys, devices=WORLD):
    out = train_cli.main(["--arch", "gemma2-2b-smoke", "--device", "cpu",
                          "--devices", str(devices), "--steps", str(steps),
                          "--batch", "4", "--seq", "16", "--schedule",
                          "auto", "--bucket-mb", "auto", "--bucket-codec",
                          "auto", "--calibrate", "--checkpoint-dir",
                          str(ckpt), "--checkpoint-every", "1"])
    text = capsys.readouterr().out
    plan = [line for line in text.splitlines()
            if line.startswith("superstep: ")]
    assert len(plan) == 1, text
    return out, text, plan[0]


def test_cli_calibrates_persists_and_reloads(tmp_path, capsys):
    out, text, plan = _train(tmp_path, 1, capsys)
    path = tmp_path / train_cli.CALIBRATION_FILE
    assert "fitted fitted-cpu4: alpha=" in text
    data = json.loads(path.read_text())
    assert list(data) == ["link"]
    link = JLinkParams(**data["link"])        # the reference's format
    assert link.name == "fitted-cpu4" and plan.endswith(
        "(link=fitted-cpu4)")
    assert out["engine"].link == CAL.LinkParams(**data["link"])
    out2, text2, plan2 = _train(tmp_path, 2, capsys)
    assert f"calibrate: reloaded fitted-cpu4 from {path}" in text2
    assert "fitted fitted-cpu4" not in text2
    assert plan2 == plan
    assert "resumed from" in text2 and out2["final_step"] == 2
    assert np.isfinite(out2["history"][0]["loss"])


def test_cli_loads_a_reference_file_and_skips_world_one(tmp_path, capsys):
    link = JLinkParams(alpha_s=3e-6, bw_Bps=2e11, name="from-reference",
                       hop_s=1e-7)
    (tmp_path / "link_calibration.json").write_text(json.dumps(
        {"link": dataclasses.asdict(link)}, indent=2))
    out, text, plan = _train(tmp_path, 1, capsys)
    assert "calibrate: reloaded from-reference from" in text
    assert out["engine"].link == CAL.LinkParams(**dataclasses.asdict(link))
    assert plan.endswith("(link=from-reference)")
    _, text1, plan1 = _train(tmp_path / "w1", 1, capsys, devices=1)
    assert "calibrate: skipped (needs ≥2 devices; pass --devices 8)" in text1
    assert plan1.endswith("(link=v5e-ici)")
