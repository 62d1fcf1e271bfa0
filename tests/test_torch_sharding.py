"""Port parity: the sharding surface (``launch/mesh.py``,
``models/sharding.py``, ``models/act_sharding.py``).

  * ``param_specs`` ``==`` the reference's, leaf for leaf in the
    reference's order (paths too), for every arch of the registry at full
    width (``meta`` shapes on the port's side, ``jax.eval_shape`` on the
    reference's) on the abstract meshes (4, 4), (16, 16), (2, 16, 16),
    (8, 1) and (1, 1), in both modes; ``port_param_specs`` gives each of
    the port's tensors that spec without a stacked leaf's leading None;
  * ``cache_specs`` ``==`` the reference's for the contiguous, paged and
    hybrid caches on the same meshes;
  * ``batch_spec``, ``describe`` and the production meshes;
  * ``shard`` ``==`` the blocks the reference's ``device_put`` places on
    each device of an 8-device (4, 2) mesh (``addressable_shards``), and
    ``unshard`` inverts it; ``check_spec`` and ``elastic.reshard_state``
    raise where ``device_put`` raises;
  * each activation hook's fixed spec (``act_sharding.LAST_SPEC``) ``==``
    the output spec of the reference's hook under ``jax.jit`` with the
    same policy (both with trailing Nones dropped, as jax prints them).

The 8-device half of the reference runs in a subprocess started at
module start (this file's ``__main__``, forced host devices).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
MESH = ((4, 2), ("data", "model"))
X_SHAPE = (8, 8, 6)
# specs of X_SHAPE that device_put takes, and specs it refuses
SHARD_SPECS = [(), ("data",), (None, "model"), (("data", "model"),),
               (("model", "data"),), ("model", "data"), (None, None, "model"),
               (None, ("model", "data")), ("data", None, "model")]
BAD_SPECS = [("pod",), ("data", "data"), (None, None, None, None),
             (None, None, "data"), ("model", ("data", "model"))]
# (hook, shape, dp axes, SERVE_EP, SEQ_SHARD)
HOOK_CASES = [
    ("hidden", (8, 4, 6), ("data",), False, False),
    ("hidden", (6, 4, 6), ("data",), False, False),
    ("hidden", (8, 4, 6), ("data",), False, True),
    ("hidden", (8, 4, 6), ("pod", "data"), False, False),
    ("logits", (8, 4, 6), ("data",), False, False),
    ("logits", (8, 4, 5), ("data",), False, False),
    ("moe_buf", (8, 4, 2, 6), ("data",), False, False),
    ("moe_buf", (8, 3, 2, 6), ("data",), False, False),
    ("moe_buf", (8, 8, 2, 6), ("data",), True, False),
    ("moe_buf", (8, 4, 2, 6), ("data",), True, False),
    ("scores_sshard", (8, 2, 1, 6), ("data",), False, False),
    ("scores_sshard", (8, 2, 1, 5), ("data",), False, False),
    ("kv", (8, 6, 2, 4), ("data",), False, False),
]


def _strip(spec):
    spec = [tuple(s) if isinstance(s, (list, tuple)) else s for s in spec]
    while spec and spec[-1] is None:
        spec.pop()
    return [list(s) if isinstance(s, tuple) else s for s in spec]


def reference_main(out_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.launch.mesh import make_mesh
    from repro.models import act_sharding as ACT

    assert len(jax.devices()) == 8, jax.devices()
    mesh = make_mesh(*MESH)
    x = np.arange(np.prod(X_SHAPE), dtype=np.float32).reshape(X_SHAPE)
    out = {"ids": np.vectorize(lambda d: d.id)(mesh.devices).tolist(),
           "shards": [], "bad": [], "hooks": []}
    for spec in SHARD_SPECS:
        y = jax.device_put(x, NamedSharding(mesh, P(*spec)))
        out["shards"].append({str(s.device.id): np.asarray(s.data).tolist()
                              for s in y.addressable_shards})
    for spec in BAD_SPECS:
        try:
            jax.device_put(x, NamedSharding(mesh, P(*spec)))
            out["bad"].append(None)
        except Exception as exc:              # ValueError, DuplicateSpecError
            out["bad"].append(type(exc).__name__)
    for name, shape, dp, serve_ep, seq in HOOK_CASES:
        ACT.set_policy(mesh, dp)
        ACT.SERVE_EP, ACT.SEQ_SHARD = serve_ep, seq
        # a fresh function each case: jit would reuse a trace of the same
        # hook and shape made under another policy
        y = jax.jit(lambda x, f=getattr(ACT, name): f(x))(jnp.zeros(shape))
        out["hooks"].append(_strip(y.sharding.spec))
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
# in-process parity
# ---------------------------------------------------------------------------

import functools  # noqa: E402

import jax  # noqa: E402

from repro.compat import abstract_mesh as jabstract_mesh  # noqa: E402
from repro.launch.mesh import describe as jdescribe  # noqa: E402
from repro.models import sharding as JSH  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.registry import ARCH_IDS  # noqa: E402
from repro.models.registry import get_config as jget_config  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.models import act_sharding as ACT  # noqa: E402
from repro_torch.models import sharding as SH  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.registry import get_config, param_shapes  # noqa
from repro_torch.runtime.elastic import reshard_state  # noqa: E402
from repro_torch.weights import reference_leaves  # noqa: E402

@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MESHES = [((4, 4), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((8, 1), ("data", "model")), ((1, 1), ("data", "model"))]
MESH_IDS = ["4x4", "16x16", "2x16x16", "8x1", "1x1"]


def _path(path):
    return "/".join(str(JSH._path_keys([p])[0]) for p in path)


def _ref_items(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return [(_path(p), tuple(s)) for p, s in flat]


@functools.lru_cache(maxsize=None)
def _ref_pshape(arch):
    cfg = jget_config(arch)
    return jax.eval_shape(lambda k: JT.init_params(cfg, k),
                          jax.random.key(0))


@pytest.mark.parametrize("shape,axes", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, shape, axes):
    cfg, jcfg = get_config(arch), jget_config(arch)
    shapes = param_shapes(cfg)
    jmesh, mesh = jabstract_mesh(shape, axes), M.abstract_mesh(shape, axes)
    for mode in ("train", "serve"):
        want = _ref_items(JSH.param_specs(jcfg, _ref_pshape(arch), jmesh,
                                          mode=mode))
        got = SH.param_specs(cfg, shapes, mesh, mode=mode)
        assert [(p, tuple(s)) for p, s in got.items()] == want, mode
        assert all(isinstance(s, SH.P) for s in got.values())
        assert list(got.values()) == [s for _, s in want]


def test_port_param_specs_drop_the_stacked_axis():
    cfg = get_config("gemma2-2b")
    shapes = param_shapes(cfg)
    specs = SH.param_specs(cfg, shapes, M.abstract_mesh((4, 4),
                                                        ("data", "model")))
    tree = SH.port_param_specs(cfg, shapes, specs)
    for leaf in reference_leaves(shapes, cfg):
        want = specs[leaf.path]
        for i, part in enumerate(leaf.parts):
            got = tree
            for k in _port_keys(cfg, leaf.path, i):
                got = got[k]
            assert len(got) == part.ndim
            assert got == (want[1:] if leaf.path.startswith("segments/")
                           else want)


def _port_keys(cfg, path, rep):
    """The port's keys of repeat ``rep`` of a reference leaf path."""
    from repro_torch.weights import layer_index
    keys = [int(k) if k.isdigit() else k for k in path.split("/")]
    if keys[0] != "segments":
        return keys
    si, j = keys[1], int(keys[2][1:])
    layer = layer_index(cfg).index((si, j, rep))
    return ["layers", layer] + keys[3:]


def _hybrid_ref(jcfg, kv_batch, kv_len, rec_batch):
    return jax.eval_shape(lambda: JT.init_hybrid_cache(
        jcfg, kv_batch=kv_batch, kv_len=kv_len, rec_batch=rec_batch))


@pytest.mark.parametrize("shape,axes", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_reference(arch, shape, axes):
    """Contiguous (8 rows of 64, and one row), paged (33 blocks of 16:
    a block count no data axis divides) and, for recurrent-bearing archs,
    hybrid (kv rows 16, 9 state rows) caches."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    jmesh, mesh = jabstract_mesh(shape, axes), M.abstract_mesh(shape, axes)
    cases = []
    if T.has_recurrent(cfg):
        cases.append((_hybrid_ref(jcfg, 16, 64, 9),
                      SH.cache_shapes(cfg, 16, 64, rec_batch=9)))
        cases.append((_hybrid_ref(jcfg, 33, 16, 9),
                      SH.cache_shapes(cfg, 33, 16, rec_batch=9)))
    else:
        for b, n in ((8, 64), (1, 64), (33, 16)):
            cases.append((jax.eval_shape(lambda: JT.init_cache(jcfg, b, n)),
                          SH.cache_shapes(cfg, b, n)))
    for jshape, pshape in cases:
        want = _ref_items(JSH.cache_specs(jcfg, jshape, jmesh))
        got = SH.cache_specs(cfg, pshape, mesh)
        assert [(p, tuple(s)) for p, s in got.items()] == want


def test_cache_shapes_are_the_caches_shapes():
    for arch in ("gemma2-2b-smoke", "jamba-v0.1-52b-smoke"):
        cfg = get_config(arch)
        if T.has_recurrent(cfg):
            real = T.init_hybrid_cache(cfg, kv_batch=4, kv_len=8,
                                       rec_batch=3, device="cpu")
            meta = SH.cache_shapes(cfg, 4, 8, rec_batch=3)
        else:
            real = T.init_cache(cfg, 4, 8, device="cpu")
            meta = SH.cache_shapes(cfg, 4, 8)
        assert [(k, tuple(v.shape), v.dtype) for c in real
                for k, v in sorted(c.items())] == \
            [(k, tuple(v.shape), v.dtype) for c in meta
             for k, v in sorted(c.items())]
        assert all(v.device.type == "meta" for c in meta for v in c.values())


@pytest.mark.parametrize("shape,axes", MESHES, ids=MESH_IDS)
def test_batch_spec_and_describe(shape, axes):
    jmesh, mesh = jabstract_mesh(shape, axes), M.abstract_mesh(shape, axes)
    want = {k: tuple(v) for k, v in JSH.batch_spec(jmesh).items()}
    assert {k: tuple(v) for k, v in SH.batch_spec(mesh).items()} == want
    assert M.describe(mesh) == jdescribe(jmesh)
    assert SH.fsdp_axes(mesh) == JSH.fsdp_axes(jmesh)
    assert dict(mesh.shape) == dict(jmesh.shape)
    assert mesh.size == int(np.prod(shape)) and mesh.device is None


def test_production_meshes():
    for multi, shape, axes in ((False, (16, 16), ("data", "model")),
                               (True, (2, 16, 16), ("pod", "data", "model"))):
        mesh = M.make_production_mesh(multi_pod=multi)
        assert (tuple(mesh.shape.values()), mesh.axis_names) == (shape, axes)
        assert M.describe(mesh) == jdescribe(jabstract_mesh(shape, axes))
        assert mesh.device is None
    assert M.describe(M.make_production_mesh()) == "data=16 × model=16"
    mesh = M.make_mesh((2, 3), ("data", "model"), device="cpu")
    assert mesh.devices.tolist() == [[0, 1, 2], [3, 4, 5]]
    assert mesh.coords(4) == (1, 1) and mesh.device == torch.device("cpu")
    with pytest.raises(ValueError):
        M.make_mesh((2, 2), ("data",), device="cpu")
    with pytest.raises(ValueError):
        M.make_mesh((2, 2), ("data", "model"), devices=[0, 1, 1, 2],
                    device="cpu")


def test_partition_spec_normalises_as_jax():
    from jax.sharding import PartitionSpec as JP
    for parts in [(("data",), None), ((), "model"), (("pod", "data"),),
                  (["data", "model"], None), ()]:
        assert SH.P(*parts) == JP(*parts)
        assert tuple(SH.P(*parts)) == tuple(JP(*parts))
    assert SH.P(None, None) != SH.P()


def _port_mesh(ref_run):
    return M.make_mesh(*MESH, devices=ref_run["ids"], device="cpu")


def test_shard_matches_device_put(ref_run):
    mesh = _port_mesh(ref_run)
    x = torch.arange(int(np.prod(X_SHAPE)),
                     dtype=torch.float32).reshape(X_SHAPE)
    for spec, want in zip(SHARD_SPECS, ref_run["shards"]):
        blocks = SH.shard(x, mesh, SH.P(*spec))
        assert blocks.shape[0] == 8
        for d in range(8):
            np.testing.assert_array_equal(blocks[d].numpy(),
                                          np.array(want[str(d)]))
        assert torch.equal(SH.unshard(blocks, mesh, SH.P(*spec)), x)


def test_bad_specs_raise_where_device_put_raises(ref_run):
    mesh = _port_mesh(ref_run)
    x = torch.zeros(X_SHAPE)
    for spec, want in zip(BAD_SPECS, ref_run["bad"]):
        assert want is not None, spec          # each one the reference refuses
        with pytest.raises(ValueError):
            SH.check_spec(X_SHAPE, mesh, SH.P(*spec))
        with pytest.raises(ValueError):
            reshard_state({"x": x}, mesh, {"x": SH.P(*spec)})
    for spec in SHARD_SPECS:
        got = reshard_state({"x": x}, mesh, {"x": SH.P(*spec)})
        assert got["x"].device == torch.device("cpu")


def test_reshard_state_trees():
    mesh = M.make_mesh((4, 1), ("data", "model"), device="cpu")
    w = torch.ones(8, 4, requires_grad=True)
    state = {"a": [w, torch.zeros(4)], "b": torch.zeros(8)}
    out = reshard_state(state, mesh, {"a": SH.P("data"), "b": SH.P()})
    assert out["a"][0].requires_grad and not out["a"][1].requires_grad
    assert torch.equal(out["a"][0], w) and out["a"][0] is not w
    with pytest.raises(ValueError):               # not a tree prefix
        reshard_state(state, mesh, {"b": SH.P()})
    with pytest.raises(ValueError):               # 4 does not divide 6
        reshard_state(torch.zeros(6), mesh, SH.P("data"))
    with pytest.raises(ValueError):               # an abstract mesh
        reshard_state(state, M.abstract_mesh((4, 1), ("data", "model")),
                      SH.P())


@pytest.fixture
def _policy():
    yield
    ACT.clear_policy()
    ACT.SERVE_EP = ACT.SEQ_SHARD = False


def test_hooks_fix_the_reference_specs(ref_run, _policy):
    mesh = _port_mesh(ref_run)
    for (name, shape, dp, serve_ep, seq), want in zip(HOOK_CASES,
                                                     ref_run["hooks"]):
        ACT.set_policy(mesh, dp)
        ACT.SERVE_EP, ACT.SEQ_SHARD = serve_ep, seq
        x = torch.zeros(shape)
        ACT.LAST_SPEC = None
        assert getattr(ACT, name)(x) is x
        assert _strip(ACT.LAST_SPEC) == want, (name, shape, dp, serve_ep)


def test_hooks_without_a_policy_do_nothing(_policy):
    ACT.clear_policy()
    x = torch.zeros(8, 4, 6)
    ACT.LAST_SPEC = None
    for hook in (ACT.hidden, ACT.logits, ACT.kv):
        assert hook(x) is x
    assert ACT.moe_buf(torch.zeros(8, 4, 2, 6)) is not None
    assert ACT.LAST_SPEC is None


def test_fixed_spec_drops_what_does_not_fit():
    mesh = M.abstract_mesh((4, 2), ("data", "model"))
    assert ACT.fixed_spec((8, 3, 6), (("pod", "data"), "model", None),
                          mesh) == SH.P("data", None, None)
    assert ACT.fixed_spec((6, 4), ("data", ("data", "model")),
                          mesh) == SH.P(None, None)
    assert ACT.fixed_spec((8, 8), (None, ("data", "model")),
                          mesh) == SH.P(None, ("data", "model"))
