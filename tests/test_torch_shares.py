"""Port parity: uneven per-rank micro-batch shares (ROADMAP A4).

  * ``reshard_for_shares`` ``==`` the reference's, layouts and refusals;
  * in the port, a step with uneven shares is bit for bit a step with even
    shares of the same micro-batches (params, loss), at world 8 on
    qwen2.5-3b-smoke: the reference's own claim
    (``tests/train_soak_checks.py``), which rests on the Neumaier pairs
    and the fixed canonical combine order;
  * a shares step at world 4 against the reference's, run on 4 host
    devices in a subprocess (this file's ``__main__``), with the
    tolerances of ``tests/test_torch_train.py`` and their reasons: step
    0's loss within 2e-5 (same params and batch); the first step's
    reduced gradient, read exactly from the first moment (mu = 0.1·g),
    within 1e-5 of each bucket's largest |g| (float noise of the two
    backward passes); params after each step within 2·lr per step taken
    (AdamW turns a tiny gradient's sign into a full step), at most 0.1 %
    of them off by more than lr/10; step 1's loss within 1e-4;
  * ``init_state.superstep_layout`` equal to the reference's;
  * ``shares=`` with ``grad_accum > 1``, a length other than the world or
    a share below 1 raise, as in the reference.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen2.5-3b-smoke"
WORLD = 4
SHARES = (3, 1, 2, 2)
STEPS = 2
SEQ, DATA_SEED = 16, 3
LR = 1e-3
BUCKET_MB = 0.25


def _acfg_kwargs():
    return dict(lr=LR, warmup_steps=1, total_steps=100, grad_clip=0.0)


def reference_main(out_path):
    import jax
    import jax.numpy as jnp

    from repro.core.bsp import BSPConfig
    from repro.data.pipeline import (DataConfig, SyntheticLM,
                                     reshard_for_shares)
    from repro.launch.mesh import make_mesh
    from repro.models import transformer as JT
    from repro.models.registry import get_config
    from repro.optim import adamw
    from repro.runtime import trainer

    assert len(jax.devices()) == WORLD, jax.devices()
    cfg = get_config(ARCH)
    mesh = make_mesh((WORLD, 1), ("data", "model"))
    data = SyntheticLM(cfg, DataConfig(global_batch=sum(SHARES),
                                       seq_len=SEQ, seed=DATA_SEED))
    params0 = JT.init_params(cfg, jax.random.key(0))
    step, init_state = trainer.make_bsp_train_step(
        cfg, mesh, adamw.AdamWConfig(**_acfg_kwargs()),
        BSPConfig(sync_axes=("data",), schedule="fractal",
                  bucket_mb=BUCKET_MB), shares=SHARES)
    out = {"layout": np.array(init_state.superstep_layout)}
    state = init_state(jax.tree.map(jnp.array, params0))
    for s in range(STEPS):
        b = {k: jnp.asarray(v) for k, v in
             reshard_for_shares(data.batch(s), SHARES).items()}
        *state, m = step(*state, b)
        out[f"loss{s}"] = np.asarray(m["loss"])
        out[f"params{s}"] = np.concatenate(
            [np.asarray(l, np.float32).reshape(-1)
             for l in jax.tree.leaves(state[0])])
        if s == 0:
            out["mu0"] = np.asarray(state[1])
    np.savez(out_path, **out)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops, which a thread pool per worker only slows when the
    suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _ref_proc(tmp_path_factory):
    """Start the reference run as the module's first test starts, so that
    it overlaps the in-process tests; ``ref_run`` waits for it."""
    path = tmp_path_factory.mktemp("ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD} "
               + os.environ.get("XLA_FLAGS", ""),
               PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, __file__, str(path)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ref_run(_ref_proc):
    proc, path = _ref_proc
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, out[-3000:] + err[-3000:]
    return dict(np.load(path))


if __name__ == "__main__":
    reference_main(sys.argv[1])
    sys.exit(0)


# ---------------------------------------------------------------------------
# in-process parity
# ---------------------------------------------------------------------------

import jax  # noqa: E402

from repro.data.pipeline import reshard_for_shares as j_reshard  # noqa
from repro.models import transformer as JT  # noqa: E402
from repro.models.registry import get_config as jget_config  # noqa: E402
from repro_torch.core.bsp import BSPConfig  # noqa: E402
from repro_torch.data.pipeline import (DataConfig, SyntheticLM,  # noqa
                                       reshard_for_shares)
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.registry import get_config  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.runtime import trainer  # noqa: E402
from repro_torch.weights import from_jax_params, reference_leaves  # noqa


@pytest.mark.parametrize("shares,rows", [
    ((2, 2, 2, 2), 8), ((3, 1, 2, 2), 8), ((3, 1, 2, 2), 16),
    ((1,), 3), ((5, 1, 1), 14), ((3, 1, 2, 2, 2, 2, 2, 2), 16)])
def test_reshard_for_shares_equals_reference(shares, rows):
    rng = np.random.default_rng(len(shares) + rows)
    batch = {"tokens": rng.integers(0, 99, (rows, 5)).astype(np.int32),
             "labels": rng.integers(0, 99, (rows, 5)).astype(np.int32)}
    got, want = reshard_for_shares(batch, shares), j_reshard(batch, shares)
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("shares,rows", [((), 4), ((2, 0), 4),
                                         ((3, 2), 4)])
def test_reshard_for_shares_refusals_match(shares, rows):
    batch = {"tokens": np.zeros((rows, 2), np.int32)}
    with pytest.raises(ValueError):
        j_reshard(batch, shares)
    with pytest.raises(ValueError):
        reshard_for_shares(batch, shares)


def _params(cfg_name=ARCH):
    jp = JT.init_params(jget_config(cfg_name), jax.random.key(0))
    return from_jax_params(jax.tree.map(np.asarray, jp),
                           get_config(cfg_name), device="cpu")


def _flat(state, cfg):
    return torch.cat([t.detach().reshape(-1)
                      for leaf in reference_leaves(state.params, cfg)
                      for t in leaf.parts])


def test_uneven_shares_bit_identical_to_even_at_world_8():
    cfg = get_config(ARCH)
    raw = SyntheticLM(cfg, DataConfig(global_batch=16, seq_len=SEQ,
                                      seed=DATA_SEED)).batch(0)
    outs = []
    for shares in [(2,) * 8, (3, 1, 2, 2, 2, 2, 2, 2), (1, 1, 1, 1, 3, 3,
                                                         3, 3)]:
        step, init = trainer.make_bsp_train_step(
            cfg, AdamWConfig(**_acfg_kwargs()),
            BSPConfig(schedule="fractal", bucket_mb=BUCKET_MB), 8,
            device="cpu", shares=shares)
        state, m = step(init(_params()), reshard_for_shares(raw, shares))
        outs.append((_flat(state, cfg), m["loss"].item(), m["xent"].item(),
                     state.flat_mu.clone()))
    (p0, l0, x0, mu0), *rest = outs
    for p, l, x, mu in rest:
        assert l == l0 and x == x0
        assert torch.equal(p, p0), "uneven shares changed the update bits"
        assert torch.equal(mu, mu0)


def test_shares_step_tracks_reference(ref_run):
    cfg = get_config(ARCH)
    step, init_state = trainer.make_bsp_train_step(
        cfg, AdamWConfig(**_acfg_kwargs()),
        BSPConfig(schedule="fractal", bucket_mb=BUCKET_MB), WORLD,
        device="cpu", shares=SHARES)
    assert init_state.superstep_layout == str(ref_run["layout"])
    state = init_state(_params())
    data = SyntheticLM(cfg, DataConfig(global_batch=sum(SHARES),
                                       seq_len=SEQ, seed=DATA_SEED))
    eng = init_state.engine
    for s in range(STEPS):
        state, m = step(state, reshard_for_shares(data.batch(s), SHARES))
        assert abs(m["loss"].item() - float(ref_run[f"loss{s}"])) <= \
            (2e-5 if s == 0 else 1e-4)
        if s == 0:
            g = state.flat_mu.numpy() / 0.1
            gref = ref_run["mu0"].reshape(WORLD, -1) / 0.1
            for b, s_off in zip(eng.buckets, eng.shard_offsets()):
                sl = slice(s_off, s_off + eng.shard_len(b))
                gmax = float(np.abs(gref[:, sl]).max())
                err = np.abs(g[:, sl] - gref[:, sl]).max()
                assert err <= 1e-6 + 1e-5 * gmax, (b.index, err, gmax)
        diff = np.abs(_flat(state, cfg).numpy() - ref_run[f"params{s}"])
        assert diff.max() <= 2 * LR * (s + 1), (s, diff.max())
        assert np.mean(diff > LR / 10) <= 1e-3


def test_even_shares_track_the_even_split():
    """Even shares of one micro-batch a rank and the plain step on the
    same rows reduce the same gradient (sum orders differ: float noise)."""
    cfg = get_config(ARCH)
    raw = SyntheticLM(cfg, DataConfig(global_batch=WORLD, seq_len=SEQ,
                                      seed=DATA_SEED)).batch(0)
    flats = []
    for shares in ((1,) * WORLD, None):
        step, init = trainer.make_bsp_train_step(
            cfg, AdamWConfig(**_acfg_kwargs()), BSPConfig(), WORLD,
            device="cpu", shares=shares)
        state, m = step(init(_params()), raw)
        flats.append((state.flat_mu.clone(), m["loss"].item()))
    (mu_s, l_s), (mu_e, l_e) = flats
    assert abs(l_s - l_e) <= 1e-6
    torch.testing.assert_close(mu_s, mu_e, rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("kw,match", [
    (dict(shares=(2, 2, 2, 2), grad_accum=2), "mutually exclusive"),
    (dict(shares=(2, 2, 2)), "entries for world size"),
    (dict(shares=(2, 0, 2, 2)), ">= 1 micro-batch"),
])
def test_shares_refusals(kw, match):
    with pytest.raises(ValueError, match=match):
        trainer.make_bsp_train_step(get_config(ARCH), AdamWConfig(),
                                    BSPConfig(), WORLD, device="cpu", **kw)


def test_shares_batch_must_fit_the_layout():
    step, init = trainer.make_bsp_train_step(
        get_config(ARCH), AdamWConfig(), BSPConfig(), WORLD, device="cpu",
        shares=SHARES)
    bad = {"tokens": np.zeros((7, SEQ), np.int32),
           "labels": np.zeros((7, SEQ), np.int32)}
    with pytest.raises(ValueError, match="reshard_for_shares"):
        step(init(_params()), bad)
