"""Port parity: the BSP training path (loss, data, the superstep, the CLI).

  * ``loss_fn`` and its gradients against ``jax.value_and_grad`` of the
    reference's, on the reference's params (f32 smoke model; atol 2e-5 on
    the loss, 1e-5 + 1e-3 relative on gradients: the same arithmetic summed
    in another order), at a short length and at 2048 tokens, where both
    sides switch to checkpointed query blocks;
  * ``SyntheticLM`` batches, equal;
  * three steps of ``make_bsp_train_step`` at world 4 with the fractal
    schedule, for codecs none/bf16/int8 and for ``grad_accum`` 2, and with
    the train CLI's ``--schedule auto --bucket-mb auto --bucket-codec auto``
    (every bucket's schedule, codec and boundary left to the autotuner; the
    reference's plan and the port's must be the same), against
    the reference's step run once per module on a 4-device host mesh in a
    subprocess (this file's ``__main__``, which writes an npz).  Tolerances,
    with their reasons:
      - step 0's loss: same params, same batch → atol 2e-5;
      - the first step's reduced gradient, read exactly from the first
        moment (mu = 0.1·g after one step from zero), bucket by bucket,
        against the largest |g| of the bucket: codec none within 1e-5 of
        it (float noise of the two backward passes, measured ~1e-6); bf16
        within one bf16 step of it, 2^-8 (two gradients that differ by
        float noise may round to neighbouring bf16 values on the wire;
        measured ~1e-3); int8 within two quanta, 2/127 (one per hop at
        world 4, where a noisy value falls on the other side of a rounding
        boundary; measured ~3e-3).  In every case at most 0.1 % of the
        elements are off by more than float noise (1e-6 + 1e-3 relative);
        the auto run holds each bucket to its own codec's bound;
      - params after each step: AdamW's m̂/√v̂ turns a gradient's sign into
        a full-size step, so a tiny gradient that differs by float noise
        moves its parameter by up to 2·lr the other way: atol 2·lr per
        step taken, and at most 0.1 % of the elements off by more than
        lr/10 (measured: none; the largest difference ~1e-4);
      - losses of steps 1-2: atol 1e-4 (they follow the params; measured
        ~1e-6).
  * the CLI on ``--device cpu`` (a forced non-fractal schedule and each
    auto value among its runs), and its refusals.

The card's own test of the step is marked ``cuda`` and skips here.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
ARCH = "gemma2-2b-smoke"
WORLD = 4
STEPS = 3
BATCH, SEQ, DATA_SEED = 8, 32, 3
LR = 1e-3
# (name, bucket_codec, grad_accum); every case but "auto" buckets at
# 0.25 MB with the fractal schedule
CASES = [("none", None, 1), ("bf16", "bf16", 1), ("int8", "int8", 1),
         ("accum2", None, 2), ("auto", "auto", 1)]
BUCKET_MB = 0.25
AUTO_FLAGS = ["--schedule", "auto", "--bucket-mb", "auto",
              "--bucket-codec", "auto"]


def _bsp_kwargs(name, codec):
    if name == "auto":
        return dict(schedule="auto", bucket_mb="auto", bucket_codec="auto")
    return dict(schedule="fractal", bucket_mb=BUCKET_MB, bucket_codec=codec)


def _acfg_kwargs():
    return dict(lr=LR, warmup_steps=1, total_steps=100, grad_clip=0.0)


# ---------------------------------------------------------------------------
# the reference, in a subprocess with 4 host devices
# ---------------------------------------------------------------------------


def reference_main(out_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.core import superstep
    from repro.core.bsp import BSPConfig
    from repro.data.pipeline import DataConfig, SyntheticLM
    from repro.launch.mesh import make_mesh
    from repro.models import transformer as JT
    from repro.models.registry import get_config
    from repro.optim import adamw
    from repro.runtime import trainer

    assert len(jax.devices()) == WORLD, jax.devices()
    cfg = get_config(ARCH)
    mesh = make_mesh((WORLD, 1), ("data", "model"))
    acfg = adamw.AdamWConfig(**_acfg_kwargs())
    data = SyntheticLM(cfg, DataConfig(global_batch=BATCH, seq_len=SEQ,
                                       seed=DATA_SEED))
    params0 = JT.init_params(cfg, jax.random.key(0))
    out = {f"p0/{i}": np.asarray(l)
           for i, l in enumerate(jax.tree.leaves(params0))}
    for name, codec, accum in CASES:
        bsp = BSPConfig(sync_axes=("data",), **_bsp_kwargs(name, codec))
        step, init_state = trainer.make_bsp_train_step(
            cfg, mesh, acfg, bsp, grad_accum=accum)
        # place the state as the step returns it, so the second step
        # reuses the first step's compilation
        rep, shd = (NamedSharding(mesh, P()),
                    NamedSharding(mesh, P("data")))
        params, mu, nu, ef, count = init_state(
            jax.tree.map(jnp.array, params0))
        state = (jax.device_put(params, rep), jax.device_put(mu, shd),
                 jax.device_put(nu, shd),
                 jax.device_put(ef, shd if codec else rep),
                 jax.device_put(count, rep))
        out[f"{name}/layout"] = np.array(init_state.superstep_layout)
        eng = superstep.engine_for(
            jax.eval_shape(lambda k: JT.init_params(cfg, k),
                           jax.random.key(0)), bsp, (WORLD,),
            force_dtype=jnp.float32, zero1=True)
        out[f"{name}/plan"] = np.array(eng.describe())
        for s in range(STEPS):
            batch = {k: jnp.asarray(v) for k, v in data.batch(s).items()}
            *state, m = step(*state, batch)
            out[f"{name}/loss{s}"] = np.asarray(m["loss"])
            out[f"{name}/params{s}"] = np.concatenate(
                [np.asarray(l, np.float32).reshape(-1)
                 for l in jax.tree.leaves(state[0])])
            if s == 0:
                out[f"{name}/mu0"] = np.asarray(state[1])
    np.savez(out_path, **out)


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
import jax.numpy as jnp  # noqa: E402

from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.registry import get_config as jget_config  # noqa: E402
from repro_torch.core.bsp import BSPConfig  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels.tree_reduce import ops  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.registry import get_config  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.runtime.trainer import make_bsp_train_step  # noqa: E402
from repro_torch.weights import from_jax_params, reference_leaves  # noqa


@pytest.fixture(scope="module")
def ref_params():
    return JT.init_params(jget_config(ARCH), jax.random.key(0))


def _port_params(ref_tree, device="cpu"):
    np_tree = jax.tree.map(np.asarray, ref_tree)
    return from_jax_params(np_tree, get_config(ARCH), device=device)


def _batch(seed, B, Tlen, vocab):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, vocab, (B, Tlen)).astype(np.int32)
    labels[0, :3] = -1                                   # masked positions
    return {"tokens": rng.integers(0, vocab, (B, Tlen)).astype(np.int32),
            "labels": labels}


@pytest.mark.parametrize("Tlen", [24, 2048])
def test_loss_and_grads_match_reference(ref_params, Tlen):
    cfg = get_config(ARCH)
    batch = _batch(Tlen, 1 if Tlen > 512 else 2, Tlen, cfg.vocab_size)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, jget_config(ARCH), b), has_aux=True))(
        ref_params, {k: jnp.asarray(v) for k, v in batch.items()})
    params = _port_params(ref_params)
    leaves = reference_leaves(params, cfg)
    flat = [t.requires_grad_(True) for leaf in leaves for t in leaf.parts]
    loss, metrics = T.loss_fn(params, cfg, {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
    grads = iter(torch.autograd.grad(loss, flat))
    assert abs(loss.item() - float(jl)) <= 2e-5
    assert abs(metrics["xent"].item() - float(jm["xent"])) <= 2e-5
    for leaf, want in zip(leaves, jax.tree.leaves(jg)):
        got = torch.stack([next(grads) for _ in leaf.parts]) \
            if leaf.path.startswith("segments/") else next(grads)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-3, atol=1e-5, err_msg=leaf.path)


def test_forward_matches_reference_logits(ref_params):
    cfg = get_config(ARCH)
    tokens = _batch(5, 2, 20, cfg.vocab_size)["tokens"]
    want = np.asarray(JT.forward(ref_params, jget_config(ARCH),
                                 jnp.asarray(tokens)))
    with torch.no_grad():
        got = T.forward(_port_params(ref_params), cfg,
                        torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("seed,B,Tlen", [(0, 8, 32), (7, 4, 129)])
def test_synthetic_batches_equal_reference(seed, B, Tlen):
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    port = SyntheticLM(cfg, DataConfig(global_batch=B, seq_len=Tlen,
                                       seed=seed))
    ref = JSyntheticLM(jcfg, JDataConfig(global_batch=B, seq_len=Tlen,
                                         seed=seed))
    for step in (0, 1, 5):
        a, b = port.batch(step), ref.batch(step)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def _run_port(ref_run, name, codec, accum):
    cfg = get_config(ARCH)
    params = _port_params(_ref_tree(ref_run))
    # the auto case takes its config from the train CLI's own parse
    bsp = train_cli.bsp_config(train_cli.parse_args(
        ["--arch", ARCH] + AUTO_FLAGS)) if name == "auto" \
        else BSPConfig(**_bsp_kwargs(name, codec))
    step, init_state = make_bsp_train_step(
        cfg, AdamWConfig(**_acfg_kwargs()), bsp, WORLD, grad_accum=accum,
        device="cpu")
    state = init_state(params)
    data = SyntheticLM(cfg, DataConfig(global_batch=BATCH, seq_len=SEQ,
                                       seed=DATA_SEED))
    out = {"layout": init_state.superstep_layout,
           "engine": init_state.engine}
    for s in range(STEPS):
        state, m = step(state, data.batch(s))
        out[f"loss{s}"] = m["loss"].item()
        out[f"params{s}"] = torch.cat([
            t.detach().reshape(-1).float()
            for leaf in reference_leaves(state.params, cfg)
            for t in leaf.parts]).numpy()
        if s == 0:
            out["mu0"] = state.flat_mu.clone().numpy()
    return out


def _ref_tree(ref_run):
    """The reference's params0 (saved by the subprocess) as its tree."""
    jparams = JT.init_params(jget_config(ARCH), jax.random.key(0))
    leaves, treedef = jax.tree.flatten(jparams)
    saved = [ref_run[f"p0/{i}"] for i in range(len(leaves))]
    for a, b in zip(leaves, saved):
        assert np.array_equal(np.asarray(a), b)
    return jax.tree.unflatten(treedef, saved)


@pytest.mark.parametrize("name,codec,accum", CASES)
def test_bsp_steps_track_reference(ref_run, name, codec, accum):
    got = _run_port(ref_run, name, codec, accum)
    assert got["layout"] == str(ref_run[f"{name}/layout"])
    assert got["engine"].describe() == str(ref_run[f"{name}/plan"])
    assert abs(got["loss0"] - float(ref_run[f"{name}/loss0"])) <= 2e-5
    for s in (1, 2):
        assert abs(got[f"loss{s}"] - float(ref_run[f"{name}/loss{s}"])) \
            <= 1e-4

    # the first step's reduced gradient, bucket by bucket (mu0 = 0.1 g)
    eng = got["engine"]
    g = got["mu0"] / 0.1
    gref = ref_run[f"{name}/mu0"].reshape(WORLD, -1) / 0.1
    assert g.shape == gref.shape
    rels = {"none": 1e-5, "bf16": 2.0 ** -8, "int8": 2 / 127}
    off_total = n_total = 0
    for b, s_off, c in zip(eng.buckets, eng.shard_offsets(),
                           eng.codec_names):
        rel = rels[c]
        sl = slice(s_off, s_off + eng.shard_len(b))
        gb, rb = g[:, sl], gref[:, sl]
        gmax = float(np.abs(rb).max())
        err = np.abs(gb - rb)
        assert err.max() <= 1e-6 + rel * gmax, (b.index, err.max(), gmax)
        off_total += int((err > 1e-6 + 1e-3 * gmax).sum())
        n_total += err.size
    assert off_total <= 1e-3 * n_total, (off_total, n_total)

    for s in range(STEPS):
        diff = np.abs(got[f"params{s}"] - ref_run[f"{name}/params{s}"])
        assert diff.max() <= 2 * LR * (s + 1), (s, diff.max())
        assert np.mean(diff > LR / 10) <= 1e-3, (s, np.mean(diff > LR / 10))


def test_step_refuses_unported_options():
    cfg = get_config(ARCH)
    acfg = AdamWConfig()
    with pytest.raises(NotImplementedError, match="shares"):
        make_bsp_train_step(cfg, acfg, BSPConfig(), WORLD, device="cpu",
                            shares=[1, 1, 1, 1])
    with pytest.raises(ValueError, match="power-of-two"):
        make_bsp_train_step(cfg, acfg, BSPConfig(), 3, device="cpu")
    with pytest.raises(ValueError, match="grad_accum"):
        make_bsp_train_step(cfg, acfg, BSPConfig(), WORLD, grad_accum=0,
                            device="cpu")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_trains_on_cpu(capsys):
    out = train_cli.main(["--arch", ARCH, "--device", "cpu", "--devices",
                          "4", "--steps", "3", "--schedule", "fractal",
                          "--bucket-codec", "int8"])
    text = capsys.readouterr().out
    assert "loss: first=" in text and " last=" in text
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "fractal+int8" in text and "world=4" in text


@pytest.mark.parametrize("extra,match", [
    (["--schedule", "xla"], "A12"),
    (["--calibrate"], "A13"),
    (["--checkpoint-dir", "ckpt"], "A5"),
])
def test_cli_refuses_unported_flags(extra, match):
    with pytest.raises(NotImplementedError, match=match):
        train_cli.main(["--arch", ARCH, "--device", "cpu", "--steps", "1"]
                       + extra)


@pytest.mark.parametrize("extra,plan", [
    (["--schedule", "ring", "--bucket-codec", "int8", "--bucket-mb",
      "0.25"], "MB→ring, b1:"),
    (["--bucket-mb", "auto"], "[dp]"),
    (["--bucket-codec", "auto", "--bucket-mb", "0.25"], "+int8"),
    (AUTO_FLAGS, "[dp]"),
], ids=["ring", "bucket-mb-auto", "bucket-codec-auto", "all-auto"])
def test_cli_runs_the_ported_flags(capsys, extra, plan):
    """A forced non-fractal schedule (its codec normalised away) and each
    auto value train through the CLI; the printed plan shows the pick."""
    out = train_cli.main(["--arch", ARCH, "--device", "cpu", "--devices",
                          "4", "--steps", "1", "--batch", "8", "--seq",
                          "32"] + extra)
    text = capsys.readouterr().out
    assert plan in text and "loss: first=" in text
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 1 and all(np.isfinite(losses))
    eng = out["engine"]
    if "ring" in extra:
        assert set(eng.schedules) == {"ring"}
        assert set(eng.codec_names) == {"none"}


def test_cli_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--arch", ARCH, "--steps", "1"])


@pytest.mark.cuda
def test_cuda_step_goes_through_the_kernels():
    """On the card: two steps of the int8 superstep launch B2 once per
    reduce hop of every bucket, and track the CPU run (the kernels equal
    their plain versions; the model's arithmetic differs by float noise)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card via chip_smoke / "
                    "pytest -m cuda)")
    cfg = get_config(ARCH)
    losses = {}
    for dev in ("cpu", "cuda"):
        step, init_state = make_bsp_train_step(
            cfg, AdamWConfig(**_acfg_kwargs()),
            BSPConfig(bucket_mb=BUCKET_MB, bucket_codec="int8"), WORLD,
            device=dev)
        params = _port_params(
            JT.init_params(jget_config(ARCH), jax.random.key(0)), dev)
        state = init_state(params)
        before = ops.INT8_LAUNCHES
        data = SyntheticLM(cfg, DataConfig(global_batch=BATCH, seq_len=SEQ,
                                           seed=DATA_SEED))
        losses[dev] = [step(state, data.batch(s))[1]["loss"].item()
                       for s in range(2)]
        n = ops.INT8_LAUNCHES - before
        assert n == (0 if dev == "cpu" else 2 * init_state.engine.n_buckets
                     * 2)
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], atol=1e-3)
