"""Port parity: mesh-sharded serving (``ServeEngine(mesh=)``,
``launch.serve --devices N``).

  * the reference's ``test_serve_cli_sharded_slots`` case through the
    port's CLI (``--devices 8``: "devices=8", "8/8 completed"), its
    outputs token-identical to the run without ``--devices``, and
    ``--mode wave`` printing the reference's note;
  * the engine's per-leaf shardings ``==`` the reference engine's
    (``x.sharding.spec`` of every param and cache leaf, in its leaf
    order) for gemma2-2b-smoke and jamba-v0.1-52b-smoke over the
    contiguous and the paged cache (8 slots on an 8-device ("data",)
    mesh; the reference in a subprocess with 8 host devices, this file's
    ``__main__``);
  * token identity with ``mesh=None`` over paged, contiguous and Jamba's
    hybrid caches (greedy and sampled);
  * the reference's ``ValueError`` (its message too) when ``max_slots``
    does not divide among the mesh's devices.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
# (arch, kv_mode) of the per-leaf sharding comparison
CASES = [("gemma2-2b-smoke", "contiguous"), ("gemma2-2b-smoke", "paged"),
         ("jamba-v0.1-52b-smoke", "contiguous"),
         ("jamba-v0.1-52b-smoke", "paged")]
SLOTS, MAX_LEN, BLOCK = 8, 32, 8


def _ecfg_kwargs(kv_mode):
    return dict(max_slots=SLOTS, max_len=MAX_LEN, prefill_chunk=8,
                kv_mode=kv_mode, block_size=BLOCK)


def reference_main(out_path):
    import jax

    from repro.launch.mesh import make_mesh
    from repro.models import transformer as JT
    from repro.models.registry import get_config
    from repro.serve import EngineConfig, ServeEngine

    assert len(jax.devices()) == 8, jax.devices()
    mesh = make_mesh((8,), ("data",))
    out = {}
    for arch, kv in CASES:
        cfg = get_config(arch)
        eng = ServeEngine(cfg, JT.init_params(cfg, jax.random.key(0)),
                          EngineConfig(**_ecfg_kwargs(kv)), mesh=mesh)
        out[f"{arch}/{kv}"] = {
            part: [[list(e) if isinstance(e, tuple) else e
                    for e in x.sharding.spec]
                   for x in jax.tree.leaves(getattr(eng, part))]
            for part in ("params", "cache")}
    cfg = get_config(CASES[0][0])
    try:
        ServeEngine(cfg, JT.init_params(cfg, jax.random.key(0)),
                    EngineConfig(max_slots=6, max_len=MAX_LEN),
                    mesh=make_mesh((4,), ("data",),
                                   devices=jax.devices()[:4]))
        out["error"] = None
    except ValueError as exc:
        out["error"] = str(exc)
    with open(out_path, "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module", autouse=True)
def _ref_proc(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "ref.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
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
    with open(path) as f:
        return json.load(f)


if __name__ == "__main__":
    reference_main(sys.argv[1])
    sys.exit(0)


# ---------------------------------------------------------------------------
# in-process
# ---------------------------------------------------------------------------

import numpy as np  # noqa: E402

from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.registry import get_config  # noqa: E402
from repro_torch.serve import EngineConfig, Request, ServeEngine  # noqa


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops, which a thread pool per worker only slows when the
    suite's workers share the cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _js(shardings):
    return [[list(e) if isinstance(e, tuple) else e for e in s.spec]
            for s in shardings.values()]


@pytest.mark.parametrize("arch,kv", CASES)
def test_engine_shardings_match_reference(ref_run, arch, kv):
    cfg = get_config(arch)
    eng = ServeEngine(cfg, T.init_params(cfg, 0, device="cpu"),
                      EngineConfig(**_ecfg_kwargs(kv)),
                      mesh=make_mesh((8,), ("data",), device="cpu"))
    want = ref_run[f"{arch}/{kv}"]
    assert _js(eng.shardings["params"]) == want["params"]
    assert _js(eng.shardings["cache"]) == want["cache"]
    assert all(s.mesh is eng.mesh for part in eng.shardings.values()
               for s in part.values())


def test_max_slots_must_divide_among_devices(ref_run):
    cfg = get_config("gemma2-2b-smoke")
    with pytest.raises(ValueError) as exc:
        ServeEngine(cfg, T.init_params(cfg, 0, device="cpu"),
                    EngineConfig(max_slots=6, max_len=MAX_LEN),
                    mesh=make_mesh((4,), ("data",), device="cpu"))
    assert str(exc.value) == ref_run["error"]
    with pytest.raises(ValueError, match="must divide across 4 devices"):
        serve_cli.main(["--arch", "gemma2-2b-smoke", "--device", "cpu",
                        "--max-slots", "6", "--devices", "4"])


def _requests(cfg, n=10, plen=9, gen=6, seed=1):
    rng = np.random.default_rng(seed)
    return [Request(req_id=i, prompt=rng.integers(
        0, cfg.vocab_size, size=(plen,)).tolist(),
        max_new_tokens=int(rng.integers(2, gen + 1))) for i in range(n)]


@pytest.mark.parametrize("arch,kv,temperature", [
    ("gemma2-2b-smoke", "paged", 0.0), ("gemma2-2b-smoke", "contiguous", 0.0),
    ("gemma2-2b-smoke", "paged", 0.8),
    ("jamba-v0.1-52b-smoke", "paged", 0.0),
    ("jamba-v0.1-52b-smoke", "contiguous", 0.0)])
def test_mesh_serving_is_token_identical(arch, kv, temperature):
    cfg = get_config(arch)
    outs = []
    for mesh in (None, make_mesh((4,), ("data",), device="cpu")):
        params = T.init_params(cfg, 0, device="cpu")
        eng = ServeEngine(cfg, params, EngineConfig(
            **dict(_ecfg_kwargs(kv), temperature=temperature)), mesh=mesh)
        outs.append(eng.run(_requests(cfg)))
        assert eng.metrics.summary()["completed"] == 10
    assert outs[0] == outs[1]


def test_cli_sharded_slots(capsys):
    """The reference's ``test_serve_cli_sharded_slots``, and the same run
    without ``--devices``."""
    base = ["--arch", "gemma2-2b-smoke", "--device", "cpu", "--requests",
            "8", "--prompt-len", "8", "--gen", "4", "--max-slots", "8",
            "--prefill-chunk", "8"]
    sharded, _ = serve_cli.main(base + ["--devices", "8"])
    out = capsys.readouterr().out
    assert "devices=8" in out and "8/8 completed" in out
    plain, _ = serve_cli.main(base)
    assert "devices=" not in capsys.readouterr().out
    assert sharded == plain
    serve_cli.main(base + ["--devices", "8", "--mode", "wave"])
    assert "note: --devices 8 ignored in wave mode" in \
        capsys.readouterr().out
