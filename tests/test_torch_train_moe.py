"""Port parity: training the MTP and MoE models (DeepSeek-V3, Qwen3-MoE).

At deepseek-v3-671b-smoke (MLA, a sigmoid router, a shared expert, one MTP
module) and qwen3-moe-235b-a22b-smoke (``attn_moe``, softmax router), f32,
on the reference's params carried over by ``weights.from_jax_params``:

  * ``loss_fn``'s loss and metrics (``xent``, ``aux``, ``mtp``) and every
    gradient leaf against ``jax.value_and_grad`` of the reference's
    ``loss_fn``: loss and metrics within 2e-5, gradients within
    1e-5 + 1e-3 relative (as ``tests/test_torch_train.py``: the same
    arithmetic summed in another order), and no leaf without a gradient;
  * the MoE backward alone (``layers.apply_moe`` and its balance loss)
    against ``jax.grad`` of the reference's, with and without capacity
    drops and with one expert that no token picks: that expert's weights
    get a zero gradient (a tensor, not a missing one) and dropped picks no
    expert gradient, as in JAX;
  * 2 steps of ``make_bsp_train_step`` at world 4 against the reference's
    steps, DeepSeek-V3 with the int8 codec and Qwen3-MoE with none (each
    codec once: a reference step costs a compile), each run in its own
    subprocess with 4 host devices (this file's ``__main__``), with the
    tolerances of ``tests/test_torch_train.py``, stated there with their
    reasons;
  * one ``launch.train`` run of each on ``--device cpu``, its history
    carrying the reference's metrics (``mtp`` included).

The step harness (``reference_main``, ``check_steps`` and the rest) is
shared with ``tests/test_torch_train_recurrent.py``.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["deepseek-v3-671b-smoke", "qwen3-moe-235b-a22b-smoke"]
WORLD = 4
STEPS = 2
LR = 1e-3
BUCKET_MB = 1.0
DATA_SEED = 3
# (arch, global batch, seq, bucket codec) of this file's step runs: each
# codec once per file (a reference step costs a compile of ~10-20 s)
RUNS = [(ARCHS[0], 8, 16, "int8"), (ARCHS[1], 8, 16, None)]


def _acfg_kwargs():
    return dict(lr=LR, warmup_steps=1, total_steps=100, grad_clip=0.0)


# ---------------------------------------------------------------------------
# the reference, in a subprocess with 4 host devices
# ---------------------------------------------------------------------------


def reference_main(out_path, runs):
    """The reference's params and ``STEPS`` BSP steps of each run
    ``(arch, batch, seq, codec)``, into an npz."""
    import jax
    import jax.numpy as jnp

    from repro.core.bsp import BSPConfig
    from repro.data.pipeline import DataConfig, SyntheticLM
    from repro.launch.mesh import make_mesh
    from repro.models import transformer as JT
    from repro.models.registry import get_config
    from repro.optim import adamw
    from repro.runtime import trainer

    assert len(jax.devices()) == WORLD, jax.devices()
    mesh = make_mesh((WORLD, 1), ("data", "model"))
    acfg = adamw.AdamWConfig(**_acfg_kwargs())
    out = {}
    for arch, batch, seq, codec in runs:
        cfg = get_config(arch)
        data = SyntheticLM(cfg, DataConfig(global_batch=batch, seq_len=seq,
                                           seed=DATA_SEED))
        params0 = JT.init_params(cfg, jax.random.key(0))
        for i, leaf in enumerate(jax.tree.leaves(params0)):
            out[f"{arch}/p0/{i}"] = np.asarray(leaf)
        bsp = BSPConfig(sync_axes=("data",), schedule="fractal",
                        bucket_mb=BUCKET_MB, bucket_codec=codec)
        step, init_state = trainer.make_bsp_train_step(cfg, mesh, acfg, bsp)
        state = init_state(jax.tree.map(jnp.array, params0))
        key = f"{arch}/{codec}"
        out[f"{key}/layout"] = np.array(init_state.superstep_layout)
        for s in range(STEPS):
            b = {k: jnp.asarray(v) for k, v in data.batch(s).items()}
            *state, m = step(*state, b)
            out[f"{key}/loss{s}"] = np.asarray(m["loss"])
            out[f"{key}/params{s}"] = np.concatenate(
                [np.asarray(leaf, np.float32).reshape(-1)
                 for leaf in jax.tree.leaves(state[0])])
            if s == 0:
                out[f"{key}/mu0"] = np.asarray(state[1])
    np.savez(out_path, **out)


def start_reference(tmp_path_factory, script, runs):
    """Start ``script``'s ``__main__`` (the reference's steps) once for
    each of ``runs``, each in its own subprocess with 4 host devices, all
    at once; returns ``[(proc, npz path)]``."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD} "
               + os.environ.get("XLA_FLAGS", ""),
               PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = []
    for arch, batch, seq, codec in runs:
        path = tmp_path_factory.mktemp("ref") / "ref.npz"
        procs.append((subprocess.Popen(
            [sys.executable, str(script), str(path),
             f"{arch}:{batch}:{seq}:{codec or 'none'}"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True), path))
    return procs


def wait_reference(procs):
    """The merged npz contents of ``start_reference``'s runs."""
    out = {}
    for proc, path in procs:
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, stdout[-3000:] + stderr[-3000:]
        out.update(np.load(path))
    return out


def stop_reference(procs):
    for proc, _ in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def parse_runs(argv):
    return [(a, int(b), int(t), None if c == "none" else c) for a, b, t, c in
            (x.rsplit(":", 3) for x in argv)]


@pytest.fixture(scope="module", autouse=True)
def _ref_proc(tmp_path_factory):
    """The reference's steps start with the module's first test and
    overlap the in-process tests; ``ref_run`` waits for them."""
    procs = start_reference(tmp_path_factory, __file__, RUNS)
    yield procs
    stop_reference(procs)


@pytest.fixture(scope="module")
def ref_run(_ref_proc):
    return wait_reference(_ref_proc)


if __name__ == "__main__":
    reference_main(sys.argv[1], parse_runs(sys.argv[2:]))
    sys.exit(0)


# ---------------------------------------------------------------------------
# shared harness: reference and port on the same params and batches
# ---------------------------------------------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.registry import get_config as jget_config  # noqa: E402
from repro_torch.core.bsp import BSPConfig  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.registry import get_config  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.runtime.trainer import make_bsp_train_step  # noqa: E402
from repro_torch.weights import from_jax_params, reference_leaves  # noqa


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops, which a thread pool per worker only slows when the
    suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_params(arch):
    return JT.init_params(jget_config(arch), jax.random.key(0))


def port_params(arch, jparams):
    return from_jax_params(jax.tree.map(np.asarray, jparams),
                           get_config(arch), device="cpu")


def make_batch(seed, B, Tlen, vocab):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, vocab, (B, Tlen)).astype(np.int32)
    labels[0, :3] = -1                                   # masked positions
    return {"tokens": rng.integers(0, vocab, (B, Tlen)).astype(np.int32),
            "labels": labels}


def reference_value_and_grad(arch, jparams, batch):
    """``jax.value_and_grad`` of the reference's ``loss_fn`` (a fresh
    ``jax.jit``, so a monkeypatched module global is traced anew)."""
    jcfg = jget_config(arch)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, jcfg, b), has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), {k: float(v) for k, v in metrics.items()}, \
        [np.asarray(g) for g in jax.tree.leaves(grads)]


def port_value_and_grad(arch, jparams, batch):
    """The port's loss, metrics and gradients, each gradient as the
    reference's (layer-stacked) leaf; a leaf outside the graph fails."""
    cfg = get_config(arch)
    params = port_params(arch, jparams)
    leaves = reference_leaves(params, cfg)
    flat = [t.requires_grad_(True) for leaf in leaves for t in leaf.parts]
    loss, metrics = T.loss_fn(params, cfg, {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
    grads = iter(torch.autograd.grad(loss, flat, allow_unused=True))
    out = []
    for leaf in leaves:
        parts = [next(grads) for _ in leaf.parts]
        missing = [i for i, g in enumerate(parts) if g is None]
        assert not missing, f"{leaf.path}: no gradient (parts {missing})"
        out.append(torch.stack(parts).numpy()
                   if leaf.path.startswith("segments/") else parts[0].numpy())
    return loss.item(), {k: v.item() for k, v in metrics.items()}, \
        [leaf.path for leaf in leaves], out


def assert_train_parity(arch, jparams, batch, scale_atol=0.0):
    """Loss and metrics within 2e-5; each gradient element within
    ``1e-5 + 1e-3 |want| + scale_atol * max |want of its leaf|``."""
    jl, jm, jg = reference_value_and_grad(arch, jparams, batch)
    loss, metrics, paths, grads = port_value_and_grad(arch, jparams, batch)
    assert abs(loss - jl) <= 2e-5, (loss, jl)
    assert set(metrics) == set(jm), (sorted(metrics), sorted(jm))
    for k in jm:
        assert abs(metrics[k] - jm[k]) <= 2e-5, (k, metrics[k], jm[k])
    assert len(grads) == len(jg)
    for path, got, want in zip(paths, grads, jg):
        assert got.shape == want.shape, path
        tol = 1e-5 + 1e-3 * np.abs(want) \
            + scale_atol * float(np.abs(want).max())
        err = np.abs(got - want)
        assert np.all(err <= tol), (path, float(err.max()),
                                    float(np.abs(want).max()))
    return metrics


def run_port_steps(arch, batch, seq, codec, jparams):
    """``STEPS`` steps of the port's superstep at world 4 on the CPU."""
    cfg = get_config(arch)
    step, init_state = make_bsp_train_step(
        cfg, AdamWConfig(**_acfg_kwargs()),
        BSPConfig(schedule="fractal", bucket_mb=BUCKET_MB,
                  bucket_codec=codec), WORLD, device="cpu")
    state = init_state(port_params(arch, jparams))
    data = SyntheticLM(cfg, DataConfig(global_batch=batch, seq_len=seq,
                                       seed=DATA_SEED))
    out = {"layout": init_state.superstep_layout,
           "engine": init_state.engine}
    for s in range(STEPS):
        state, m = step(state, data.batch(s))
        assert set(m) >= {"loss", "xent", "aux", "lr"}
        out[f"loss{s}"] = m["loss"].item()
        out[f"metrics{s}"] = {k: v.item() for k, v in m.items()}
        out[f"params{s}"] = torch.cat([
            t.detach().reshape(-1).float()
            for leaf in reference_leaves(state.params, cfg)
            for t in leaf.parts]).numpy()
        if s == 0:
            out["mu0"] = state.flat_mu.clone().numpy()
    return out


def saved_params(ref_run, arch, flat=None):
    """The subprocess's params0, checked against this process's init; or,
    given ``flat`` (a saved ``params{s}`` vector), that step's params in
    the same tree."""
    jparams = ref_params(arch)
    leaves, treedef = jax.tree.flatten(jparams)
    saved = [ref_run[f"{arch}/p0/{i}"] for i in range(len(leaves))]
    for a, b in zip(leaves, saved):
        assert np.array_equal(np.asarray(a), b)
    if flat is not None:
        offs = np.cumsum([0] + [a.size for a in saved])
        saved = [flat[o:o + a.size].reshape(a.shape).astype(a.dtype)
                 for o, a in zip(offs, saved)]
    return jax.tree.unflatten(treedef, saved)


def _world_loss(arch, jparams, batch):
    """The world-mean loss of ``batch`` (each rank its rows), as the
    superstep reports it."""
    cfg = get_config(arch)
    params = port_params(arch, jparams)
    rows = batch["tokens"].shape[0] // WORLD
    with torch.no_grad():
        losses = [T.loss_fn(params, cfg, {
            k: torch.from_numpy(v[r * rows:(r + 1) * rows])
            for k, v in batch.items()})[0] for r in range(WORLD)]
    return (torch.stack(losses).sum() / WORLD).item()


def check_steps(ref_run, arch, batch, seq, codec, none_rel=1e-5,
                later_loss=1e-4, later_frac=1e-3):
    """The port's steps against the reference's, with the tolerances of
    ``tests/test_torch_train.py``: step 0's loss within 2e-5, later losses
    within ``later_loss`` (1e-4); the first reduced gradient (mu0 = 0.1 g)
    per bucket within ``none_rel`` (codec none) or two int8 quanta of the
    bucket's largest |g|, at most 0.1 % of elements past float noise;
    params within 2 lr a step taken; after step 0 at most 0.1 % of them
    past lr/10, after later steps ``later_frac``.  And each later step's
    loss evaluated by the port at the reference's own params of the step
    before within 2e-5: the model is the reference's wherever the params
    are, so a looser later bound measures only how far the params'
    float noise carries."""
    got = run_port_steps(arch, batch, seq, codec,
                         saved_params(ref_run, arch))
    key = f"{arch}/{codec}"
    cfg = get_config(arch)
    data = SyntheticLM(cfg, DataConfig(global_batch=batch, seq_len=seq,
                                       seed=DATA_SEED))
    assert got["layout"] == str(ref_run[f"{key}/layout"])
    assert abs(got["loss0"] - float(ref_run[f"{key}/loss0"])) <= 2e-5
    for s in range(1, STEPS):
        want = float(ref_run[f"{key}/loss{s}"])
        assert abs(got[f"loss{s}"] - want) <= later_loss, \
            (s, got[f"loss{s}"], want)
        at_ref = _world_loss(arch, saved_params(
            ref_run, arch, ref_run[f"{key}/params{s - 1}"]), data.batch(s))
        assert abs(at_ref - want) <= 2e-5, (s, at_ref, want)
    eng = got["engine"]
    g = got["mu0"] / 0.1
    gref = ref_run[f"{key}/mu0"].reshape(WORLD, -1) / 0.1
    assert g.shape == gref.shape
    rel = {"none": none_rel, "int8": 2 / 127}
    off = n = 0
    for b, s_off, c in zip(eng.buckets, eng.shard_offsets(),
                           eng.codec_names):
        sl = slice(s_off, s_off + eng.shard_len(b))
        gmax = float(np.abs(gref[:, sl]).max())
        err = np.abs(g[:, sl] - gref[:, sl])
        assert err.max() <= 1e-6 + rel[c] * gmax, (b.index, err.max(), gmax)
        off += int((err > 1e-6 + 1e-3 * gmax).sum())
        n += err.size
    assert off <= 1e-3 * n, (off, n)
    for s in range(STEPS):
        diff = np.abs(got[f"params{s}"] - ref_run[f"{key}/params{s}"])
        assert diff.max() <= 2 * LR * (s + 1), (s, diff.max())
        frac = np.mean(diff > LR / 10)
        assert frac <= (1e-3 if s == 0 else later_frac), (s, frac)
    return got


def cli_trains(arch, capsys, batch, seq):
    out = train_cli.main(["--arch", arch, "--device", "cpu", "--devices",
                          "4", "--steps", "2", "--batch", str(batch),
                          "--seq", str(seq), "--bucket-codec", "int8",
                          "--bucket-mb", str(BUCKET_MB)])
    text = capsys.readouterr().out
    assert "loss: first=" in text and "world=4" in text
    hist = out["history"]
    assert len(hist) == 2
    for h in hist:
        assert np.isfinite(h["loss"]) and np.isfinite(h["xent"])
        assert np.isfinite(h["aux"])
    return out, text


# ---------------------------------------------------------------------------
# this file's tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_metrics_and_grads_match_reference(arch):
    cfg = get_config(arch)
    batch = make_batch(1, 2, 24, cfg.vocab_size)
    metrics = assert_train_parity(arch, ref_params(arch), batch)
    want = {"xent", "aux", "mtp"} if cfg.mtp_depth else {"xent", "aux"}
    assert set(metrics) == want
    assert metrics["aux"] > 0


def test_mtp_and_aux_enter_the_loss():
    """loss == xent + mtp_loss_weight * mtp / mtp_depth + 0.01 * aux."""
    arch = ARCHS[0]
    cfg = get_config(arch)
    batch = make_batch(2, 2, 12, cfg.vocab_size)
    params = port_params(arch, ref_params(arch))
    with torch.no_grad():
        loss, m = T.loss_fn(params, cfg, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
    want = m["xent"] + cfg.mtp_loss_weight * m["mtp"] / cfg.mtp_depth \
        + 0.01 * m["aux"]
    assert abs(loss.item() - want.item()) <= 1e-6


def _moe_case(arch, cf, seed):
    """The reference's ``init_moe`` params with expert 3 made unreachable
    (a router column far below the others on positive inputs), and
    positive inputs."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    if cf is not None:
        cfg, jcfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=cf)) for c in (cfg, jcfg))
    jp = JL.init_moe(jax.random.key(seed), jcfg)
    jp = dict(jp, router={"w": jp["router"]["w"].at[:, 3].set(-1.0)})
    x = np.abs(np.random.default_rng(seed).standard_normal(
        (2, 16, cfg.d_model))).astype(np.float32)
    r = np.random.default_rng(seed + 1).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    return cfg, jcfg, jp, x, r


@pytest.mark.parametrize("cf", [None, 1.0], ids=["dropless", "drops"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_backward_matches_reference(arch, cf):
    """Gradients of ``sum(y * r) + aux`` through ``apply_moe``: the input,
    the router and every expert weight (and the shared expert's) within
    1e-5 + 1e-3 relative of ``jax.grad``'s; the unreachable expert's
    weights get zero tensors, and at cf 1.0 some picks drop."""
    cfg, jcfg, jp, x, r = _moe_case(arch, cf, 5)

    def jloss(p, x):
        y, aux = JL.apply_moe(p, jcfg, x)
        return jnp.sum(y * r) + aux

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    p = jax.tree.map(lambda a: torch.from_numpy(np.array(a))
                     .requires_grad_(True), jp)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = L.apply_moe(p, cfg, xt)
    leaves, treedef = jax.tree.flatten(p)
    grads = torch.autograd.grad((y * torch.from_numpy(r)).sum() + aux,
                                leaves + [xt], allow_unused=True)
    assert all(g is not None for g in grads)
    for got, want in zip(grads, jax.tree.leaves(jgp) + [jgx]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-3, atol=1e-5)
    gp = jax.tree.unflatten(treedef, grads[:-1])
    for name in ("w_gate", "w_up", "w_down"):
        assert not gp[name][3].any(), name        # no token, zero gradient
        assert gp[name][:3].abs().sum() > 0
    _, idx, _ = L._router_gates(p, cfg.moe, xt.detach().reshape(32, -1))
    assert not (idx == 3).any()
    mo = cfg.moe
    C = max(1, int(np.ceil(16 * mo.top_k / mo.num_experts
                           * mo.capacity_factor)))
    counts = [(idx.reshape(2, -1)[b] == e).sum().item()
              for b in range(2) for e in range(mo.num_experts)]
    assert (max(counts) > C) == (cf == 1.0), (counts, C)


@pytest.mark.parametrize("arch,batch,seq,codec", RUNS)
def test_bsp_steps_track_reference(ref_run, arch, batch, seq, codec):
    got = check_steps(ref_run, arch, batch, seq, codec)
    want = {"loss", "xent", "aux", "lr"} | (
        {"mtp"} if get_config(arch).mtp_depth else set())
    assert set(got["metrics0"]) == want
    assert all(np.isfinite(v) for v in got["metrics1"].values())


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_trains_on_cpu(arch, capsys):
    out, text = cli_trains(arch, capsys, 8, 16)
    if get_config(arch).mtp_depth:
        assert all(np.isfinite(h["mtp"]) for h in out["history"])
        assert " mtp " in text
    assert "fractal+int8" in text
