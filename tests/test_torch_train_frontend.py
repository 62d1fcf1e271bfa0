"""Port parity: BSP training of the frontend models (paligemma-3b's
prefix-LM, musicgen-medium's sinusoidal positions).

At paligemma-3b-smoke and musicgen-medium-smoke, f32, on the reference's
params, every batch carrying ``SyntheticLM``'s frontend embeddings:

  * 2 steps of ``make_bsp_train_step`` at world 4 against the
    reference's, paligemma with the int8 codec and musicgen with none
    (each codec once: a reference step costs a compile), each in its own
    subprocess with 4 host devices (the harness of
    ``tests/test_torch_train_moe.py``), with the tolerances of
    ``tests/test_torch_train.py``, stated there with their reasons;
  * uneven ``shares`` of paligemma-smoke's micro-batches give the even
    shares' update bit for bit (the frontend rows travel with their
    tokens through ``reshard_for_shares``);
  * ``grad_accum`` 2 splits the frontend rows with the tokens: the loss
    within 1e-6 of one micro-batch a rank and the reduced gradient
    within float noise;
  * one ``launch.train`` run of each on ``--device cpu``.
"""

import sys

import numpy as np
import pytest
import torch

from test_torch_train_moe import (reference_main, parse_runs,
                                  start_reference, stop_reference,
                                  wait_reference)

ARCHS = ["paligemma-3b-smoke", "musicgen-medium-smoke"]
# each codec once per file (a reference step costs a compile)
RUNS = [(ARCHS[0], 8, 16, "int8"), (ARCHS[1], 8, 16, None)]


@pytest.fixture(scope="module", autouse=True)
def _ref_proc(tmp_path_factory):
    procs = start_reference(tmp_path_factory, __file__, RUNS)
    yield procs
    stop_reference(procs)


@pytest.fixture(scope="module")
def ref_run(_ref_proc):
    return wait_reference(_ref_proc)


if __name__ == "__main__":
    reference_main(sys.argv[1], parse_runs(sys.argv[2:]))
    sys.exit(0)


from repro_torch.core.bsp import BSPConfig  # noqa: E402
from repro_torch.data.pipeline import (DataConfig, SyntheticLM,  # noqa: E402
                                       reshard_for_shares)
from repro_torch.models.registry import get_config  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.runtime.trainer import make_bsp_train_step  # noqa: E402
from repro_torch.weights import reference_leaves  # noqa: E402

from test_torch_train_moe import (BUCKET_MB, DATA_SEED, WORLD,  # noqa: E402
                                  _acfg_kwargs, check_steps, cli_trains,
                                  port_params, ref_params)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch,batch,seq,codec", RUNS)
def test_bsp_steps_track_reference(ref_run, arch, batch, seq, codec):
    got = check_steps(ref_run, arch, batch, seq, codec)
    assert set(got["metrics0"]) == {"loss", "xent", "aux", "lr"}
    assert all(np.isfinite(v) for v in got["metrics1"].values())


def _step_once(arch, batch, **kw):
    cfg = get_config(arch)
    step, init = make_bsp_train_step(
        cfg, AdamWConfig(**_acfg_kwargs()),
        BSPConfig(schedule="fractal", bucket_mb=BUCKET_MB), WORLD,
        device="cpu", **kw)
    state, m = step(init(port_params(arch, ref_params(arch))), batch)
    flat = torch.cat([t.detach().reshape(-1)
                      for leaf in reference_leaves(state.params, cfg)
                      for t in leaf.parts])
    return flat, m, state.flat_mu.clone()


def test_uneven_shares_bit_identical_to_even():
    arch = ARCHS[0]
    cfg = get_config(arch)
    raw = SyntheticLM(cfg, DataConfig(global_batch=8, seq_len=16,
                                      seed=DATA_SEED)).batch(0)
    assert raw["frontend"].shape == (8, cfg.frontend_tokens,
                                     cfg.frontend_dim)
    outs = [_step_once(arch, reshard_for_shares(raw, shares), shares=shares)
            for shares in [(2,) * WORLD, (3, 1, 2, 2), (1, 1, 3, 3)]]
    (p0, m0, mu0), *rest = outs
    for p, m, mu in rest:
        assert m["loss"].item() == m0["loss"].item()
        assert m["xent"].item() == m0["xent"].item()
        assert torch.equal(p, p0), "uneven shares changed the update bits"
        assert torch.equal(mu, mu0)


def test_grad_accum_splits_the_frontend_rows():
    arch = ARCHS[1]
    cfg = get_config(arch)
    raw = SyntheticLM(cfg, DataConfig(global_batch=8, seq_len=16,
                                      seed=DATA_SEED)).batch(0)
    _, m1, mu1 = _step_once(arch, raw)
    _, m2, mu2 = _step_once(arch, raw, grad_accum=2)
    assert abs(m1["loss"].item() - m2["loss"].item()) <= 1e-6
    torch.testing.assert_close(mu2, mu1, rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_trains_on_cpu(arch, capsys):
    out, text = cli_trains(arch, capsys, 8, 16)
    assert "fractal+int8" in text
    assert f"arch={arch}" in text
