"""Port parity: serving DeepSeek-V3 (MLA + MoE + MTP params) end to end on
the CPU, at deepseek-v3-671b-smoke.

* Configs and parameter counts (total and active) equal the reference's,
  for the full config and its smoke variant; ``from_jax_params`` carries
  every reference leaf, the MTP list and the f32 router included.
* Chunked paged prefill, then batched decode steps, through both packages
  on the same tokens, tables and offsets: logits within f32 atol 1e-4
  (two MLA + MoE layers, summed in other orders), latent pools within
  1e-5, under both decode lowerings.
* The port's paged engine is token-identical to the reference's paged
  engine (its "ref" lowering) with the same metrics summary; random-init
  smoke models decode near-constant tokens (ROADMAP C1), so the logits
  check above is the stronger one.
* The serve CLI completes every request on the CPU and launches no
  kernel there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import registry as JR
from repro.models import transformer as JT
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch import weights
from repro_torch.kernels.paged_attention import ops
from repro_torch.launch import serve as serve_cli
from repro_torch.models import registry as R
from repro_torch.models import transformer as T
from repro_torch.serve import EngineConfig, Request, ServeEngine

ARCH = "deepseek-v3-671b-smoke"
LOGIT_ATOL = 1e-4
POOL_ATOL = 1e-5


@pytest.fixture(scope="module")
def cfgs():
    return R.get_config(ARCH), JR.get_config(ARCH)


@pytest.fixture(scope="module")
def params(cfgs):
    cfg, jcfg = cfgs
    jp = JT.init_params(jcfg, jax.random.key(0))
    return weights.from_jax_params(jax.tree.map(np.asarray, jp), cfg,
                                   device="cpu"), jp


@pytest.mark.parametrize("name", ["deepseek-v3-671b",
                                  "deepseek-v3-671b-smoke"])
def test_config_and_param_counts_match_reference(name):
    ours, ref = R.get_config(name), JR.get_config(name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.segments() == ref.segments()
    for active in (False, True):
        assert R.count_params(ours, active) == JR.count_params(ref, active)
    assert R.embedding_params(ours) == JR.embedding_params(ref)
    assert R.non_embedding_params(ours, True) == \
        JR.non_embedding_params(ref, True)


def test_five_layer_cut_counts():
    """The depth cut the card serves: 3 dense MLA layers + 2 MLA+MoE
    layers (+ the MTP module) at full width; equal to the reference."""
    cut = dict(num_layers=5, layer_pattern=("mla",) * 3 + ("mla_moe",) * 2)
    ours = dataclasses.replace(R.get_config("deepseek-v3-671b"), **cut)
    ref = dataclasses.replace(JR.get_config("deepseek-v3-671b"), **cut)
    assert ours.segments() == ((tuple(cut["layer_pattern"]), 1),)
    assert R.count_params(ours) == JR.count_params(ref) == 27_304_638_464


def test_from_jax_params_carries_every_leaf(params, cfgs):
    """Every reference leaf lands, bit for bit, at its port position (one
    segment unit of 2 kinds at smoke size: layer i is
    segments[0]["l{i}"][...][0]), the MTP list and the router included."""
    cfg, _ = cfgs
    p, jp = params
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    unit = len(cfg.segments()[0][0])
    seen = 0
    for path, leaf in flat:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        leaf = np.asarray(leaf)
        if keys[0] == "segments":
            j = int(keys[2][1:])
            for r in range(leaf.shape[0]):
                node = p["layers"][r * unit + j]
                for k in keys[3:]:
                    node = node[k]
                assert node.dtype == weights._to_tensor(leaf[r],
                                                        "cpu").dtype
                np.testing.assert_array_equal(node.numpy(), leaf[r])
                seen += 1
        else:
            node = p
            for k in keys:
                node = node[k]
            np.testing.assert_array_equal(node.numpy(), leaf)
            seen += 1
    assert seen == sum(1 for _ in R._leaves(p))
    assert len(p["mtp"]) == cfg.mtp_depth == 1
    assert set(p["mtp"][0]) == {"proj", "block", "norm"}
    assert p["layers"][1]["ffn"]["router"]["w"].dtype == torch.float32
    shapes = T.init_params(cfg, device="meta")
    assert jax.tree.map(lambda t: tuple(t.shape), shapes) == \
        jax.tree.map(lambda t: tuple(t.shape), p)


def test_init_paged_cache_latent_pools(cfgs):
    cfg, jcfg = cfgs
    cache = T.init_paged_cache(cfg, 5, 4, device="cpu")
    ref = weights.unstack_layers(
        jax.tree.map(np.asarray, JT.init_paged_cache(jcfg, 5, 4)), cfg,
        device="cpu")
    assert len(cache) == len(ref) == cfg.num_layers
    for a, b in zip(cache, ref):
        assert set(a) == set(b) == {"c_kv", "k_rope"}
        for leaf in a:
            assert a[leaf].shape == b[leaf].shape
            assert not a[leaf].any()


def test_forward_matches_reference(cfgs, params):
    cfg, jcfg = cfgs
    p, jp = params
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 11))
    got = T.forward(p, cfg, torch.from_numpy(toks))
    want = JT.forward(jp, jcfg, jnp.asarray(toks, jnp.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_ATOL)


def _pools_close(ours, theirs_np, cfg):
    theirs = weights.unstack_layers(theirs_np, cfg, device="cpu")
    for a, b in zip(ours, theirs):
        for leaf in ("c_kv", "k_rope"):
            np.testing.assert_allclose(a[leaf][1:].numpy(),
                                       b[leaf][1:].numpy(), rtol=0,
                                       atol=POOL_ATOL)


@pytest.mark.parametrize("kernel",
                         ["ref", pytest.param("auto", id="kernel")])
def test_prefill_then_decode_matches_reference(cfgs, params, kernel):
    cfg, jcfg = cfgs
    p, jp = params
    N, bs, n, C = 16, 4, 6, 4
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=(plen,)).astype(np.int64)
               for plen in (10, 3)]
    tables = np.zeros((3, n), np.int32)
    tables[0, :4] = [5, 2, 9, 12]
    tables[1, :2] = [7, 3]                      # row 2: masked (sentinel)
    jprefill = jax.jit(
        lambda p_, t, c, o, bt: JT.prefill_chunk(p_, jcfg, t, c, o,
                                                 block_tables=bt))
    jpk = "pallas" if kernel == "auto" else "ref"
    jdecode = jax.jit(lambda p_, t, c, o, bt: JT.decode_step(
        p_, jcfg, t, c, o, block_tables=bt, paged_kernel=jpk))

    cache = T.init_paged_cache(cfg, N, bs, device="cpu")
    jcache = JT.init_paged_cache(jcfg, N, bs)
    for row, prompt in enumerate(prompts):
        plen = len(prompt)
        starts = [0] if plen <= C else list(range(0, plen - C, C)) + [plen - C]
        for s in starts:
            chunk = np.zeros((1, C), np.int64)
            part = prompt[s:s + C]
            chunk[0, :len(part)] = part
            tab = tables[row:row + 1]
            lg, cache = T.prefill_chunk(p, cfg, torch.from_numpy(chunk),
                                        cache, s,
                                        block_tables=torch.from_numpy(tab))
            jlg, jcache = jprefill(jp, jnp.asarray(chunk, jnp.int32),
                                   jcache, jnp.asarray(s, jnp.int32),
                                   jnp.asarray(tab))
            np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=0,
                                       atol=LOGIT_ATOL)
    _pools_close(cache, jax.tree.map(np.asarray, jcache), cfg)

    lengths = [10, 3]
    toks = np.array([[11], [17], [0]], np.int64)
    for _ in range(3):
        off = np.array(lengths + [n * bs - 1], np.int32)
        lg, cache = T.decode_step(p, cfg, torch.from_numpy(toks), cache,
                                  torch.from_numpy(off),
                                  block_tables=torch.from_numpy(tables),
                                  paged_kernel=kernel)
        jlg, jcache = jdecode(jp, jnp.asarray(toks, jnp.int32), jcache,
                              jnp.asarray(off), jnp.asarray(tables))
        np.testing.assert_allclose(lg[:2].numpy(), np.asarray(jlg)[:2],
                                   rtol=0, atol=LOGIT_ATOL)
        nxt = lg[:, 0].argmax(-1).numpy()
        toks = np.array([[nxt[0]], [nxt[1]], [0]], np.int64)
        lengths = [x + 1 for x in lengths]
    _pools_close(cache, jax.tree.map(np.asarray, jcache), cfg)


@pytest.mark.parametrize("port_kernel", ["ref", "auto"])
def test_engine_token_identical_to_reference(cfgs, params, port_kernel):
    cfg, jcfg = cfgs
    p, jp = params
    rng = np.random.default_rng(0)
    spec = [(i, rng.integers(0, cfg.vocab_size, size=(n,)).tolist(), g, a)
            for i, (n, g, a) in enumerate(zip(
                [5, 9, 3, 12], [6, 3, 7, 5], [0.0, 0.0, 0.01, 0.05]))]
    base = dict(max_slots=2, max_len=24, prefill_chunk=4,
                chunks_per_step=2, block_size=4)
    ours = ServeEngine(cfg, p, EngineConfig(kv_mode="paged",
                                            paged_kernel=port_kernel,
                                            **base))
    theirs = JServeEngine(jcfg, jp, JEngineConfig(
        kv_mode="paged", paged_kernel="ref", **base))
    out = ours.run([Request(*r) for r in spec])
    jout = theirs.run([JRequest(*r) for r in spec])
    assert out == jout
    assert ours.metrics.summary() == theirs.metrics.summary()
    assert ours.metrics.summary()["completed"] == 4


def test_cli_serves_every_request_on_cpu(capsys):
    launches = (ops.LAUNCHES, ops.MLA_LAUNCHES)
    results, metrics = serve_cli.main([
        "--arch", ARCH, "--device", "cpu", "--requests", "4",
        "--prompt-len", "6", "--gen", "5", "--gen-spread", "2",
        "--max-slots", "2", "--prefill-chunk", "4", "--block-size", "4"])
    assert sorted(results) == list(range(4))
    assert metrics.summary()["completed"] == 4
    vocab = R.get_config(ARCH).vocab_size
    assert all(0 <= t < vocab for out in results.values() for t in out)
    assert (ops.LAUNCHES, ops.MLA_LAUNCHES) == launches
    assert "paged_mla_attention kernel launches: 0" in \
        capsys.readouterr().out
