"""Port parity: checkpointing (ROADMAP A5).

  * ``checkpoint/_msgpack.py`` (the port's own codec: the card's machine
    has no msgpack) packs the format's payloads byte for byte as
    ``msgpack.packb(..., use_bin_type=True)``, reads what msgpack writes as
    ``msgpack.unpackb(..., raw=False)`` does, and refuses a bin of 2^32
    bytes (a leaf that large cannot be saved in the format: ROADMAP C7);
  * a checkpoint the reference's ``CheckpointManager`` writes loads into
    the port's with equal leaves, and the other way round: generic trees
    of f32, bf16, int32 and scalar leaves, and the BSP train state (the
    reference's ``(params, mu, nu, ef, step)`` tuple) with a codec's EF
    vector and with the ``zeros(world)`` placeholder, in f32 and bf16;
  * keep-K with the ``keep_every`` ladder, falling back past a corrupt
    file, a stray ``.tmp`` file, async save + wait, a failed save
    surfacing from ``wait()`` with its step;
  * exact resume through ``TrainLoop`` and ``resume_or_init``: four
    steps straight are bit for bit two steps, a restore and two more; a
    different ``superstep_layout`` raises; the train CLI resumes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointing import CheckpointManager as JCM
from repro.models import transformer as JT
from repro.models.registry import get_config as jget_config
from repro_torch.checkpoint import _msgpack
from repro_torch.checkpoint import checkpointing as CK
from repro_torch.checkpoint.checkpointing import CheckpointManager
from repro_torch.core.bsp import BSPConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import train as train_cli
from repro_torch.models.registry import get_config
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.loop import LoopConfig, TrainLoop, resume_or_init
from repro_torch.runtime.trainer import make_bsp_train_step
from repro_torch.weights import from_jax_params, reference_leaves

ARCH = "qwen2.5-3b-smoke"
WORLD = 4

PAYLOADS = [
    None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1,
    2**32, 2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
    -2**31 - 1, -2**63, 0.0, -0.0, 1.5, 1e300, float("inf"), "", "a" * 31,
    "b" * 32, "c" * 255, "d" * 256, "é" * 40000, b"", b"\0" * 255,
    b"1" * 256, b"2" * 65535, b"3" * 65536, [], list(range(15)),
    list(range(16)), list(range(70000)), {}, {str(i): i for i in range(15)},
    {str(i): [i] for i in range(16)}, {str(i): i for i in range(70000)},
    {"meta": {"step": 10, "treedef": "PyTreeDef((*, *))", "time": 1.7e9,
              "data_step": 10, "superstep_layout": "zero1:0123456789ab"},
     "arrays": [{"dtype": "float32", "shape": [16, 8],
                 "data": bytes(range(256)) * 2},
                {"dtype": "int32", "shape": [], "data": b"\7\0\0\0"}]},
]


@pytest.mark.parametrize("obj", PAYLOADS, ids=range(len(PAYLOADS)))
def test_msgpack_bytes_equal_msgpack(obj):
    want = msgpack.packb(obj, use_bin_type=True)
    assert _msgpack.packb(obj) == want
    assert _msgpack.unpackb(want) == msgpack.unpackb(want, raw=False)
    views = _msgpack.unpackb(bytearray(want), bin_view=True)
    assert views == msgpack.unpackb(want, raw=False)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops, which a thread pool per worker only slows when the
    suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_msgpack_bin_limit_and_bad_input():
    for what, codes in (("bin", (0xC4, 0xC5, 0xC6)),
                        ("str", (0xD9, 0xDA, 0xDB))):
        assert _msgpack._header(2**32 - 1, 0, -1, codes, what) == \
            bytes([codes[2]]) + b"\xff\xff\xff\xff"
        with pytest.raises(ValueError, match="over msgpack's limit"):
            _msgpack._header(2**32, 0, -1, codes, what)
    with pytest.raises(TypeError):
        _msgpack.packb({1, 2})
    with pytest.raises(ValueError):
        _msgpack.unpackb(msgpack.packb([1, 2])[:-1])
    with pytest.raises(ValueError):
        _msgpack.unpackb(msgpack.packb(1) + b"\0")


# ---------------------------------------------------------------------------
# generic trees, both ways
# ---------------------------------------------------------------------------


def _jstate(seed=0):
    k = jax.random.key(seed)
    return {"w": jax.random.normal(k, (16, 8)),
            "b16": (jnp.arange(6, dtype=jnp.bfloat16) - 2) * 1.375,
            "nested": {"b": jnp.arange(5, dtype=jnp.int32), "none": None},
            "scalar": jnp.asarray(3.5)}


def _tstate(j):
    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.uint16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())
    return {"w": conv(j["w"]), "b16": conv(j["b16"]),
            "nested": {"b": conv(j["nested"]["b"]), "none": None},
            "scalar": conv(j["scalar"])}


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _leaves_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = _np(x), _np(y)
        assert x.shape == y.shape and np.array_equal(x, y)


def test_reference_tree_loads_into_port(tmp_path):
    j = _jstate()
    JCM(str(tmp_path)).save(3, j, blocking=True, meta={"data_step": 3})
    like = _tstate(_jstate(1))
    got, meta = CheckpointManager(str(tmp_path)).restore(like)
    assert meta["step"] == meta["data_step"] == 3
    assert got["b16"].dtype == torch.bfloat16
    assert got["nested"]["none"] is None
    _leaves_equal(CK._leaf_list(got), jax.tree.leaves(j))


def test_port_tree_loads_into_reference(tmp_path):
    j = _jstate()
    CheckpointManager(str(tmp_path)).save(5, _tstate(j), blocking=True)
    got, meta = JCM(str(tmp_path)).restore(_jstate(1))
    assert meta["step"] == 5 and meta["treedef"].startswith("repro_torch")
    _leaves_equal(jax.tree.leaves(got), jax.tree.leaves(j))


def test_same_payload_as_the_reference(tmp_path):
    """The port's file and the reference's hold the same arrays and the
    same meta but for the descriptor and the time."""
    j = _jstate()
    JCM(str(tmp_path / "j")).save(2, j, blocking=True, meta={"a": 1})
    CheckpointManager(str(tmp_path / "t")).save(2, _tstate(j),
                                                blocking=True, meta={"a": 1})
    blobs = []
    for sub in ("j", "t"):
        raw = (tmp_path / sub / "step_2.ckpt").read_bytes()
        blobs.append(msgpack.unpackb(raw.partition(b"\n")[2], raw=False))
    a, b = blobs
    assert a["arrays"] == b["arrays"]
    for m in (a["meta"], b["meta"]):
        m.pop("treedef"), m.pop("time")
    assert a["meta"] == b["meta"]


# ---------------------------------------------------------------------------
# the BSP train state
# ---------------------------------------------------------------------------


def _cfgs(dtype):
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    if dtype == "bfloat16":
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
        jcfg = dataclasses.replace(jcfg, param_dtype="bfloat16")
    return cfg, jcfg


def _states(dtype, codec, seed=0):
    """The same BSP state in both packages: the port's ``BSPTrainState``
    and the reference's ``(params, mu, nu, ef, step)`` tuple (random
    moments, EF and step)."""
    cfg, jcfg = _cfgs(dtype)
    jp = JT.init_params(jcfg, jax.random.key(seed))
    _, init_state = make_bsp_train_step(
        cfg, AdamWConfig(), BSPConfig(bucket_mb=0.25, bucket_codec=codec),
        WORLD, device="cpu")
    state = init_state(from_jax_params(jax.tree.map(np.asarray, jp), cfg,
                                       device="cpu"))
    g = torch.Generator().manual_seed(seed)
    for t in (state.flat_mu, state.flat_nu, state.ef_residual):
        if t is not None:
            t.copy_(torch.randn(t.shape, generator=g))
    state.step = 7 + seed
    ef = np.zeros(WORLD, np.float32) if state.ef_residual is None \
        else state.ef_residual.reshape(-1).numpy().copy()
    jstate = (jp, jnp.asarray(state.flat_mu.reshape(-1).numpy()),
              jnp.asarray(state.flat_nu.reshape(-1).numpy()),
              jnp.asarray(ef), jnp.asarray(np.int32(state.step)))
    return state, jstate, cfg


def _port_leaves(state):
    return state.checkpoint_leaves()


CASES = [("float32", None), ("float32", "int8"), ("bfloat16", None),
         ("bfloat16", "int8")]


@pytest.mark.parametrize("dtype,codec", CASES)
def test_reference_state_loads_into_port(tmp_path, dtype, codec):
    state, jstate, cfg = _states(dtype, codec)
    JCM(str(tmp_path)).save(7, jstate, blocking=True)
    like, _, _ = _states(dtype, codec, seed=1)
    got, meta = CheckpointManager(str(tmp_path)).restore(like)
    assert got.step == 7 and meta["step"] == 7
    assert (got.ef_residual is None) == (codec is None)
    _leaves_equal(_port_leaves(got), jax.tree.leaves(jstate))
    for leaf in reference_leaves(got.params, cfg):
        assert all(p.requires_grad for p in leaf.parts)
    # the like state is left as it was
    assert like.step == 8


@pytest.mark.parametrize("dtype,codec", CASES)
def test_port_state_loads_into_reference(tmp_path, dtype, codec):
    state, jstate, _ = _states(dtype, codec)
    CheckpointManager(str(tmp_path)).save(7, state, blocking=True)
    _, jlike, _ = _states(dtype, codec, seed=1)
    got, meta = JCM(str(tmp_path)).restore(jlike)
    assert meta["step"] == 7
    _leaves_equal(jax.tree.leaves(got), jax.tree.leaves(jstate))


def test_state_of_another_world_is_refused(tmp_path):
    state, _, cfg = _states("float32", None)
    CheckpointManager(str(tmp_path)).save(1, state, blocking=True)
    _, init_state = make_bsp_train_step(cfg, AdamWConfig(), BSPConfig(), 2,
                                        device="cpu")
    like = init_state(state.params)
    with pytest.raises(ValueError, match="elements"):
        CheckpointManager(str(tmp_path)).restore(like)


# ---------------------------------------------------------------------------
# the manager's behaviours (the reference tests' cases)
# ---------------------------------------------------------------------------


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    st = _tstate(_jstate())
    mgr.save(10, st, blocking=True)
    restored, meta = mgr.restore(st)
    assert meta["step"] == 10
    _leaves_equal(CK._leaf_list(restored), CK._leaf_list(st))


def test_async_save_snapshots_now(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    st = _tstate(_jstate())
    want = st["w"].clone()
    mgr.save(1, st)
    st["w"].add_(1.0)              # the caller updates its state at once
    mgr.wait()
    assert mgr.latest_step() == 1
    assert torch.equal(mgr.restore(st)[0]["w"], want)
    assert mgr.saves[0]["step"] == 1 and mgr.saves[0]["bytes"] == \
        (tmp_path / "step_1.ckpt").stat().st_size


def test_keep_k_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, keep_every=10)
    for s in (1, 2, 3, 10, 11, 12):
        mgr.save(s, _tstate(_jstate()), blocking=True)
    steps = mgr.steps()
    assert 10 in steps
    assert steps[-2:] == [11, 12]
    assert 1 not in steps and 2 not in steps


def test_corrupt_checkpoint_falls_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    st = _tstate(_jstate())
    mgr.save(1, st, blocking=True)
    mgr.save(2, {k: (v + 1 if isinstance(v, torch.Tensor) else v)
                 for k, v in st.items()}, blocking=True)
    p = tmp_path / "step_2.ckpt"
    p.write_bytes(p.read_bytes()[:50])
    restored, meta = mgr.restore(st)
    assert meta["step"] == 1
    _leaves_equal(CK._leaf_list(restored), CK._leaf_list(st))
    raw = bytearray((tmp_path / "step_1.ckpt").read_bytes())
    raw[-1] ^= 1                               # one flipped bit
    (tmp_path / "step_1.ckpt").write_bytes(bytes(raw))
    assert mgr.restore(st) is None


def test_no_partial_files_after_crashy_tmp(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    (tmp_path / "step_9.tmp-12345").write_bytes(b"partial garbage")
    mgr.save(9, _tstate(_jstate()), blocking=True)
    restored, meta = mgr.restore(_tstate(_jstate()))
    assert meta["step"] == 9
    assert mgr.steps() == [9]


def test_failed_save_surfaces_from_wait(tmp_path, monkeypatch):
    """A leaf past the format's bin limit (here a limit cut to 64 bytes)
    fails the save; ``wait()`` raises naming the step, as the
    reference's does for a leaf of 4 GiB or more."""
    monkeypatch.setattr(_msgpack, "MAX_LEN", 64)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, {"w": torch.zeros(32)})
    with pytest.raises(IOError, match="save 3: bin of 128 bytes"):
        mgr.wait()
    assert mgr.steps() == []
    with pytest.raises(IOError, match="save 4"):
        mgr.save(4, {"w": torch.zeros(32)}, blocking=True)


# ---------------------------------------------------------------------------
# exact resume through the loop
# ---------------------------------------------------------------------------


def _trainer(cfg):
    return make_bsp_train_step(
        cfg, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10),
        BSPConfig(bucket_mb=0.25, bucket_codec="int8"), 2, device="cpu")


def _loop(cfg, step_fn, state, steps, ckpt_dir=None, start=0, meta=None):
    data = SyntheticLM(cfg, DataConfig(global_batch=4, seq_len=16, seed=1))
    loop = TrainLoop(step_fn=step_fn, state=state, data=data,
                     cfg=LoopConfig(total_steps=steps, checkpoint_every=2,
                                    log_every=0, checkpoint_dir=ckpt_dir),
                     start_step=start, ckpt_meta=meta or {})
    loop.run()
    return loop


def test_exact_resume_is_bit_identical(tmp_path):
    cfg = get_config(ARCH)
    from repro_torch.models import transformer as T
    step_fn, init_state = _trainer(cfg)
    straight = _loop(cfg, step_fn, init_state(T.init_params(cfg, 1,
                                                            device="cpu")), 4)
    meta = {"superstep_layout": init_state.superstep_layout}
    _loop(cfg, step_fn, init_state(T.init_params(cfg, 1, device="cpu")), 2,
          str(tmp_path), meta=meta)
    like = init_state(T.init_params(cfg, 2, device="cpu"))
    state, start = resume_or_init(str(tmp_path), like, expect_meta=meta)
    assert start == 2 and state.step == 2
    resumed = _loop(cfg, step_fn, state, 4, start=start)
    assert [h["loss"] for h in resumed.history] == \
        [h["loss"] for h in straight.history[2:]]
    _leaves_equal(resumed.state.checkpoint_leaves(),
                  straight.state.checkpoint_leaves())


def test_resume_refuses_another_layout(tmp_path):
    cfg = get_config(ARCH)
    from repro_torch.models import transformer as T
    step_fn, init_state = _trainer(cfg)
    _loop(cfg, step_fn, init_state(T.init_params(cfg, 1, device="cpu")), 2,
          str(tmp_path), meta={"superstep_layout": "zero1:another"})
    like = init_state(T.init_params(cfg, 1, device="cpu"))
    with pytest.raises(RuntimeError, match="superstep_layout"):
        resume_or_init(str(tmp_path), like, expect_meta={
            "superstep_layout": init_state.superstep_layout})
    assert resume_or_init(None, like) == (like, 0)
    assert resume_or_init(str(tmp_path / "empty"), like) == (like, 0)


def test_cli_checkpoints_and_resumes(tmp_path, capsys):
    argv = ["--arch", ARCH, "--device", "cpu", "--devices", "2", "--batch",
            "4", "--seq", "16", "--checkpoint-dir", str(tmp_path),
            "--checkpoint-every", "2"]
    train_cli.main(argv + ["--steps", "3"])
    assert CheckpointManager(str(tmp_path)).steps() == [2, 3]
    out = train_cli.main(argv + ["--steps", "5"])
    assert "resumed from" in capsys.readouterr().out
    assert [h["step"] for h in out["history"]] == [3, 4]
    assert CheckpointManager(str(tmp_path)).steps() == [3, 4, 5]   # keep 3
