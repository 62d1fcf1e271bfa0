"""Port parity: the GSPMD tier (``--schedule xla``).

  * three steps of ``runtime.trainer.make_gspmd_train_step`` against the
    reference's on the (4, 1) and (2, 2) meshes, for qwen2.5-3b-smoke
    (dense), qwen3-moe-235b-a22b-smoke (MoE) and paligemma-3b-smoke
    (frontend, prefix-LM), f32, from the reference's params carried over
    by ``weights.from_jax_params``, on the same batches, with the default
    global-norm clip of 1.0.  The reference runs in one subprocess per arch
    with 4 host devices (this file's ``__main__``).  Bounds, with their
    reasons:
      - step 0's loss: the same params and batch → atol 2e-5 (the same
        arithmetic summed in another order, as ``tests/test_torch_train.py``);
      - the gradient's global norm at each step: rtol 1e-4;
      - params after each step: AdamW's m̂/√v̂ turns a near-zero
        gradient's sign into a whole step of lr, so atol 2·lr per step
        taken, and at most 0.1 % of the elements off by more than lr/10;
      - losses of steps 1-2: atol 1e-4 (they follow the params);
    and the builders' specs (params, ``AdamWState(step, mu, nu)``, batch)
    ``==`` the reference's;
  * the port's xla step against its fractal step (the reference's
    ``tests/bsp_equivalence_check.py``): qwen2.5-3b-smoke, world 4,
    ``grad_clip=0`` (Tier B's clip is per shard), 3 steps, losses within
    the reference check's 2e-4 and params within 2·lr per step;
  * a checkpoint that the reference's ``--schedule xla`` CLI wrote at step
    2, restored by the port's CLI, which then takes step 2 with the
    reference's own resumed step-2 loss (atol 2e-5);
  * ``make_prefill_step`` / ``make_decode_step``: specs ``==`` the
    reference's (gemma2-2b-smoke and the MoE arch, which serves in "serve"
    mode) and gemma2-2b-smoke's logits of a prefill and a decode step
    within 1e-4 of the reference's jitted steps on a (2, 2) mesh;
  * the CLI on ``--device cpu``, whose ``--bucket-*``, ``--compression``
    and ``--calibrate`` do nothing under ``--schedule xla``, as the
    reference's.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen2.5-3b-smoke", "qwen3-moe-235b-a22b-smoke",
         "paligemma-3b-smoke"]
MESHES = [(4, 1), (2, 2)]
STEPS = 3
BATCH, SEQ, DATA_SEED = 8, 16, 3
LR = 1e-3
SERVE_ARCHS = ["gemma2-2b-smoke", "qwen3-moe-235b-a22b-smoke"]
SERVE_B, SERVE_LEN, SERVE_PROMPT = 8, 32, 8
CKPT_ARGS = ["--arch", "qwen2.5-3b-smoke", "--batch", str(BATCH), "--seq",
             str(SEQ), "--schedule", "xla", "--lr", str(LR), "--seed", "0",
             "--checkpoint-every", "2"]


def _js(specs):
    """Specs as the reference's JSON holds them (tuples as lists)."""
    return [[list(e) if isinstance(e, tuple) else e for e in s]
            for s in specs]


def _acfg_kwargs():
    return dict(lr=LR, warmup_steps=1, total_steps=100)


def _specs(tree):
    import jax
    from jax.sharding import PartitionSpec as P
    return [list(s) for s in
            jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, P))]


def reference_steps(out, arch):
    import jax
    import jax.numpy as jnp

    from repro.data.pipeline import DataConfig, SyntheticLM
    from repro.launch.mesh import make_mesh
    from repro.models import transformer as JT
    from repro.models.registry import get_config
    from repro.models.sharding import named
    from repro.optim import adamw
    from repro.runtime import trainer

    cfg = get_config(arch)
    acfg = adamw.AdamWConfig(**_acfg_kwargs())
    data = SyntheticLM(cfg, DataConfig(global_batch=BATCH, seq_len=SEQ,
                                       seed=DATA_SEED))
    for shape in MESHES:
        mesh = make_mesh(shape, ("data", "model"))
        step, (pspec, ospec, bspec) = trainer.make_gspmd_train_step(
            cfg, mesh, acfg)
        key = f"{arch}/{shape[0]}x{shape[1]}"
        out[f"{key}/ospec"] = _specs(ospec)
        out[f"{key}/bspec"] = {k: list(v) for k, v in bspec.items()}
        params = jax.device_put(JT.init_params(cfg, jax.random.key(0)),
                                named(mesh, pspec))
        # placed as the step returns it, so that step 1 reuses step 0's
        # compilation
        opt = jax.device_put(adamw.init(params, acfg), named(mesh, ospec))
        for s in range(STEPS):
            b = {k: jnp.asarray(v) for k, v in data.batch(s).items()}
            params, opt, m = step(params, opt, b)
            out[f"{key}/loss{s}"] = float(m["loss"])
            out[f"{key}/grad_norm{s}"] = float(m["grad_norm"])
            np.save(out["dir"] / f"{key.replace('/', '_')}_p{s}.npy",
                    np.concatenate([np.asarray(l, np.float32).reshape(-1)
                                    for l in jax.tree.leaves(params)]))


def reference_extra(out):
    """The CLI checkpoint (written at step 2, then resumed for step 2) and
    the serving steps."""
    import jax
    import jax.numpy as jnp

    from repro.launch import train as jtrain
    from repro.launch.mesh import make_mesh
    from repro.models import transformer as JT
    from repro.models.registry import get_config
    from repro.models.sharding import named
    from repro.runtime import trainer

    ck = out["dir"] / "ckpt"
    jtrain.main(CKPT_ARGS + ["--steps", "2", "--checkpoint-dir", str(ck)])
    shutil.copytree(ck, out["dir"] / "ckpt_step2")
    res = jtrain.main(CKPT_ARGS + ["--steps", "3", "--checkpoint-dir",
                                   str(ck)])
    out["resumed"] = [(h["step"], h["loss"]) for h in res["history"]]

    mesh = make_mesh((2, 2), ("data", "model"))
    for arch in SERVE_ARCHS:
        cfg = get_config(arch)
        for name, make in (("prefill", trainer.make_prefill_step),
                           ("decode", trainer.make_decode_step)):
            _, (pspec, cspec) = make(cfg, mesh, SERVE_B, SERVE_LEN)
            out[f"{arch}/{name}/pspec"] = _specs(pspec)
            out[f"{arch}/{name}/cspec"] = _specs(cspec)
    cfg = get_config(SERVE_ARCHS[0])
    prefill, (pspec, cspec) = trainer.make_prefill_step(cfg, mesh, SERVE_B,
                                                        SERVE_LEN)
    decode, _ = trainer.make_decode_step(cfg, mesh, SERVE_B, SERVE_LEN)
    params = jax.device_put(JT.init_params(cfg, jax.random.key(0)),
                            named(mesh, pspec))
    rng = np.random.default_rng(5)
    toks = jnp.asarray(rng.integers(0, cfg.vocab_size,
                                    (SERVE_B, SERVE_PROMPT)), jnp.int32)
    cache = jax.device_put(JT.init_cache(cfg, SERVE_B, SERVE_LEN),
                           named(mesh, cspec))
    lg, cache, n = prefill(params, toks, cache)
    tok = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
    lg2, cache = decode(params, tok, cache, jnp.asarray(n, jnp.int32))
    np.save(out["dir"] / "serve_prefill.npy", np.asarray(lg, np.float32))
    np.save(out["dir"] / "serve_decode.npy", np.asarray(lg2, np.float32))
    np.save(out["dir"] / "serve_tokens.npy", np.asarray(toks))


def reference_main(out_dir, job):
    import json

    import jax
    assert len(jax.devices()) == 4, jax.devices()
    out = {"dir": Path(out_dir)}
    if job == "extra":
        reference_extra(out)
    else:
        reference_steps(out, job)
    del out["dir"]
    with open(Path(out_dir) / f"{job}.json", "w") as f:
        json.dump(out, f)


JOBS = ARCHS + ["extra"]


@pytest.fixture(scope="module", autouse=True)
def _ref_procs(tmp_path_factory):
    """One subprocess per job, all started with the module's first test."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
               + os.environ.get("XLA_FLAGS", ""),
               PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = {}
    for job in JOBS:
        d = tmp_path_factory.mktemp("ref")
        procs[job] = (subprocess.Popen(
            [sys.executable, __file__, str(d), job], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), d)
    yield procs
    for proc, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _ref(procs, job):
    import json
    proc, d = procs[job]
    if proc.returncode is None:
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, out[-3000:] + err[-3000:]
    with open(d / f"{job}.json") as f:
        return json.load(f), d


if __name__ == "__main__":
    reference_main(sys.argv[1], sys.argv[2])
    sys.exit(0)


# ---------------------------------------------------------------------------
# in-process parity
# ---------------------------------------------------------------------------

import jax  # noqa: E402

from repro.models import transformer as JT  # noqa: E402
from repro.models.registry import get_config as jget_config  # noqa: E402
from repro_torch.core.bsp import BSPConfig  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import act_sharding as ACT  # noqa: E402
from repro_torch.models import sharding as SH  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.registry import get_config  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import trainer  # noqa: E402
from repro_torch.runtime.elastic import reshard_state  # noqa: E402
from repro_torch.weights import from_jax_params, reference_leaves  # noqa


@pytest.fixture(scope="module", autouse=True)
def _one_thread_no_policy():
    """One thread (the suite's workers share the cores); the builders'
    activation policy cleared after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    ACT.clear_policy()
    ACT.SERVE_EP = False


def _port_params(arch):
    jp = JT.init_params(jget_config(arch), jax.random.key(0))
    return from_jax_params(jax.tree.map(np.asarray, jp), get_config(arch),
                           device="cpu")


def _flat(params, cfg):
    """The params as the reference's flattened, concatenated leaves."""
    return np.concatenate([
        torch.stack([p.detach().float() for p in leaf.parts]).reshape(-1)
        .numpy() if leaf.path.startswith("segments/") else
        leaf.parts[0].detach().float().reshape(-1).numpy()
        for leaf in reference_leaves(params, cfg)])


def _gspmd_run(arch, shape, acfg, steps=STEPS):
    cfg = get_config(arch)
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    step, specs = trainer.make_gspmd_train_step(cfg, mesh, acfg)
    params = _port_params(arch)
    params = reshard_state(params, mesh,
                           SH.port_param_specs(cfg, params, specs[0]))
    state = trainer.GSPMDTrainState(params, adamw.init(params, acfg), cfg)
    data = SyntheticLM(cfg, DataConfig(global_batch=BATCH, seq_len=SEQ,
                                       seed=DATA_SEED))
    hist = []
    for s in range(steps):
        state, m = step(state, data.batch(s))
        hist.append(({k: float(v) for k, v in m.items()},
                     _flat(state.params, cfg)))
    return hist, specs, state


def _params_close(got, want, steps_taken, label):
    diff = np.abs(got - want)
    assert diff.max() <= 2 * LR * steps_taken + 1e-6, (label, diff.max())
    assert (diff > LR / 10).mean() <= 1e-3, (label, (diff > LR / 10).mean())


@pytest.mark.parametrize("shape", MESHES, ids=["4x1", "2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_gspmd_steps_track_reference(_ref_procs, arch, shape):
    acfg = adamw.AdamWConfig(**_acfg_kwargs())
    hist, (pspec, ospec, bspec), _ = _gspmd_run(arch, shape, acfg)
    ref, d = _ref(_ref_procs, arch)
    key = f"{arch}/{shape[0]}x{shape[1]}"
    for s, (m, flat) in enumerate(hist):
        tol = 2e-5 if s == 0 else 1e-4
        assert abs(m["loss"] - ref[f"{key}/loss{s}"]) <= tol, (s, m)
        np.testing.assert_allclose(m["grad_norm"], ref[f"{key}/grad_norm{s}"],
                                   rtol=1e-4)
        want = np.load(d / f"{key.replace('/', '_')}_p{s}.npy")
        _params_close(flat, want, s + 1, f"{key} step {s}")
        assert np.isfinite(m["lr"]) and "xent" in m and "aux" in m
    got_ospec = [ospec.step] + list(ospec.mu.values()) \
        + list(ospec.nu.values())
    assert _js(got_ospec) == ref[f"{key}/ospec"]
    assert dict(zip(bspec, _js(bspec.values()))) == ref[f"{key}/bspec"]


def test_xla_step_equals_fractal_step():
    """Tier A against Tier B: the same model, data and params, 3 steps."""
    arch, world = "qwen2.5-3b-smoke", 4
    acfg = adamw.AdamWConfig(**dict(_acfg_kwargs(), grad_clip=0.0))
    hist, _, _ = _gspmd_run(arch, (world, 1), acfg)
    cfg = get_config(arch)
    step, init_state = trainer.make_bsp_train_step(
        cfg, acfg, BSPConfig(schedule="fractal"), world, device="cpu")
    state = init_state(_port_params(arch))
    data = SyntheticLM(cfg, DataConfig(global_batch=BATCH, seq_len=SEQ,
                                       seed=DATA_SEED))
    for s in range(STEPS):
        state, m = step(state, data.batch(s))
        np.testing.assert_allclose(float(m["loss"]), hist[s][0]["loss"],
                                   rtol=2e-4, atol=2e-4)
        _params_close(_flat(state.params, cfg), hist[s][1], s + 1,
                      f"step {s}")


def test_reference_xla_checkpoint_resumes(_ref_procs, tmp_path, capsys):
    ref, d = _ref(_ref_procs, "extra")
    ck = tmp_path / "ckpt"
    shutil.copytree(d / "ckpt_step2", ck)
    out = train_cli.main(CKPT_ARGS + ["--device", "cpu", "--devices", "4",
                                      "--steps", "3", "--checkpoint-dir",
                                      str(ck)])
    assert f"resumed from {ck} at step 2" in capsys.readouterr().out
    (step, want), = ref["resumed"]
    hist = out["history"]
    assert [h["step"] for h in hist] == [step] == [2]
    assert abs(hist[0]["loss"] - want) <= 2e-5, (hist[0]["loss"], want)
    # the port's own checkpoint of step 3 loads back into a like state
    mgr_steps = sorted(p.name for p in ck.iterdir())
    assert "step_3.ckpt" in mgr_steps


def test_gspmd_state_checkpoint_roundtrip(tmp_path):
    from repro_torch.checkpoint.checkpointing import CheckpointManager
    arch = "qwen2.5-3b-smoke"
    acfg = adamw.AdamWConfig(**_acfg_kwargs())
    _, _, state = _gspmd_run(arch, (4, 1), acfg, steps=1)
    cfg = get_config(arch)
    n = len(reference_leaves(state.params, cfg))
    leaves = state.checkpoint_leaves()
    assert len(leaves) == state.checkpoint_leaf_count() == 3 * n + 1
    assert leaves[n].dtype == torch.int32 and int(leaves[n]) == 1
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state, blocking=True)
    params = _port_params(arch)
    like = trainer.GSPMDTrainState(params, adamw.init(params, acfg), cfg)
    back, _ = mgr.restore(like)
    for a, b in zip(back.checkpoint_leaves(), leaves):
        assert torch.equal(a, b)
    assert all(t.requires_grad for leaf in reference_leaves(back.params, cfg)
               for t in leaf.parts)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serving_step_specs_match_reference(_ref_procs, arch):
    ref, _ = _ref(_ref_procs, "extra")
    cfg = get_config(arch)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    for name, make in (("prefill", trainer.make_prefill_step),
                       ("decode", trainer.make_decode_step)):
        _, (pspec, cspec) = make(cfg, mesh, SERVE_B, SERVE_LEN)
        assert _js(pspec.values()) == ref[f"{arch}/{name}/pspec"]
        assert _js(cspec.values()) == ref[f"{arch}/{name}/cspec"]
        assert ACT.SERVE_EP == (cfg.moe is not None)
    assert trainer._serve_mode(cfg) == ("serve" if cfg.moe else "train")


def test_serving_steps_match_reference(_ref_procs):
    _, d = _ref(_ref_procs, "extra")
    cfg = get_config(SERVE_ARCHS[0])
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    prefill, _ = trainer.make_prefill_step(cfg, mesh, SERVE_B, SERVE_LEN)
    decode, _ = trainer.make_decode_step(cfg, mesh, SERVE_B, SERVE_LEN)
    params = _port_params(SERVE_ARCHS[0])
    toks = torch.from_numpy(np.load(d / "serve_tokens.npy")).long()
    cache = T.init_cache(cfg, SERVE_B, SERVE_LEN, device="cpu")
    lg, cache, n = prefill(params, toks, cache)
    np.testing.assert_allclose(lg.numpy(), np.load(d / "serve_prefill.npy"),
                               atol=1e-4, rtol=0)
    tok = lg[:, -1].argmax(-1)[:, None]
    lg2, cache = decode(params, tok, cache, n)
    np.testing.assert_allclose(lg2.numpy(), np.load(d / "serve_decode.npy"),
                               atol=1e-4, rtol=0)


def test_cli_trains_xla_on_cpu(capsys):
    out = train_cli.main(["--arch", "gemma2-2b-smoke", "--device", "cpu",
                          "--devices", "4", "--steps", "3", "--schedule",
                          "xla", "--batch", "8", "--seq", "16"])
    text = capsys.readouterr().out
    assert "loss: first=" in text and " last=" in text
    assert "gspmd: mesh data=4 × model=1" in text
    assert out["engine"] is None
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 3 and all(np.isfinite(losses))


def test_cli_xla_ignores_the_superstep_flags(capsys, tmp_path):
    """As the reference's xla path: no bucket plan, no codec, no link fit
    (``--calibrate`` writes nothing), the same losses as without them."""
    base = ["--arch", "gemma2-2b-smoke", "--device", "cpu", "--devices",
            "4", "--steps", "2", "--schedule", "xla", "--batch", "8",
            "--seq", "16"]
    plain = train_cli.main(base)
    capsys.readouterr()
    flags = train_cli.main(base + [
        "--bucket-mb", "auto", "--bucket-codec", "int8", "--compression",
        "int8", "--calibrate", "--checkpoint-dir", str(tmp_path),
        "--checkpoint-every", "100"])
    text = capsys.readouterr().out
    assert "superstep:" not in text and "calibrate" not in text
    assert not (tmp_path / train_cli.CALIBRATION_FILE).exists()
    assert [h["loss"] for h in flags["history"]] == \
        [h["loss"] for h in plain["history"]]
