"""Port parity: the contiguous KV backend and the wave oracle, on the CPU.

At gemma2-2b-smoke, qwen2.5-3b-smoke and deepseek-v3-671b-smoke (the
contiguous latent cache) with the reference's parameters, in f32:

* ``prefill`` of a batch, then three decode steps (a scalar offset, then
  per-row offsets with a row parked on the sentinel position), against
  the reference's ``prefill``/``decode_step`` over ``init_cache``: logits
  and the final caches within ``ATOL`` (the same arithmetic summed in
  other orders; DeepSeek's MoE layers add a router and an expert combine,
  so 1e-4 there, as in ``test_torch_serve_mla.py``);
* the engine's admission path, ``take_state`` → ``prefill_chunk`` →
  ``write_state`` into three slots (interior, right-aligned tail and
  end-padded chunks), then a batched decode: logits and caches against
  the reference's same calls;
* slot surgery: ``take_slot``/``write_slot``/``reset_slot`` equal the
  reference's bit for bit, and resetting one slot leaves the other slots'
  decode logits bit for bit;
* the port's contiguous engine, its paged engine and its ``serve_waves``
  give the same tokens under temperature sampling; with greedy decoding
  the contiguous engine gives the reference's contiguous engine's tokens
  and metrics summary (random-init smoke models decode near-constant
  sequences, so the logit checks above carry the weight: ROADMAP C1).
"""

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
from repro_torch.models import registry as R
from repro_torch.models import transformer as T
from repro_torch.serve import (EngineConfig, Request, ServeEngine,
                               serve_waves)

ARCHS = ["gemma2-2b", "qwen2.5-3b", "deepseek-v3-671b"]
ATOL = {"deepseek-v3-671b": 1e-4}
DENSE_ATOL = 2e-5
S = 24                         # cache positions per slot


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops, which a thread pool per worker only slows when the
    suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    name = request.param + "-smoke"
    cfg, jcfg = R.get_config(name), JR.get_config(name)
    jp = JT.init_params(jcfg, jax.random.key(0))
    p = weights.from_jax_params(jax.tree.map(np.asarray, jp), cfg,
                                device="cpu")
    return cfg, jcfg, p, jp, ATOL.get(request.param, DENSE_ATOL)


def _caches_close(cache, jcache, cfg, atol):
    jl = weights.unstack_layers(jax.tree.map(np.asarray, jcache), cfg,
                                device="cpu")
    for got, want in zip(cache, jl):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=0, atol=atol, err_msg=k)


def test_prefill_then_decode_matches_reference(arch):
    cfg, jcfg, p, jp, atol = arch
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 9))
    cache = T.init_cache(cfg, 2, S, device="cpu")
    jcache = JT.init_cache(jcfg, 2, S)
    jdecode = jax.jit(lambda p_, t, c, o: JT.decode_step(p_, jcfg, t, c, o))
    with torch.no_grad():
        lg, cache, n = T.prefill(p, cfg, torch.from_numpy(toks), cache)
        jlg, jcache, jn = JT.prefill(jp, jcfg, jnp.asarray(toks, jnp.int32),
                                     jcache)
        assert n == int(jn) == 9
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=0,
                                   atol=atol)
        nxt = lg[:, -1].argmax(-1).numpy()[:, None]
        for off in (np.int32(9), np.array([10, 10], np.int32),
                    np.array([11, S - 1], np.int32)):
            lg, cache = T.decode_step(p, cfg, torch.from_numpy(nxt), cache,
                                      torch.from_numpy(np.asarray(off)))
            jlg, jcache = jdecode(jp, jnp.asarray(nxt, jnp.int32), jcache,
                                  jnp.asarray(off))
            np.testing.assert_allclose(lg[:1].numpy(), np.asarray(jlg)[:1],
                                       rtol=0, atol=atol)
            nxt = lg[:, 0].argmax(-1).numpy()[:, None]
    _caches_close(cache, jcache, cfg, atol)


def _admit(p, cfg, cache, slot, prompt, C, prefill):
    """The engine's chunk geometry for KV-only archs: interior chunks,
    a right-aligned tail, or one end-padded chunk."""
    plen = len(prompt)
    starts = [0] if plen <= C else list(range(0, plen - C, C)) + [plen - C]
    logits = []
    for s in starts:
        chunk = np.zeros((1, C), np.int64)
        part = prompt[s:s + C]
        chunk[0, :len(part)] = part
        lg, cache = prefill(p, cache, chunk, slot, s)
        logits.append(lg)
    return logits, cache


def _admitted(arch, C=4):
    """Three slots: 0 empty, 1 a 10-token prompt, 2 a 3-token one, through
    both packages' admission paths; returns the caches and the chunk
    logits (port, reference)."""
    cfg, jcfg, p, jp, _ = arch
    rng = np.random.default_rng(2)
    prompts = {1: rng.integers(0, cfg.vocab_size, 10),
               2: rng.integers(0, cfg.vocab_size, 3)}

    def port(p_, c, chunk, slot, s):
        sub = T.take_state(cfg, c, slot)
        lg, sub = T.prefill_chunk(p_, cfg, torch.from_numpy(chunk), sub, s)
        return lg, T.write_state(cfg, c, sub, slot)

    @jax.jit
    def ref(p_, c, chunk, slot, s):
        sub = JT.take_state(jcfg, c, slot)
        lg, sub = JT.prefill_chunk(p_, jcfg, chunk, sub, s)
        return lg, JT.write_state(jcfg, c, sub, slot)

    cache = T.init_cache(cfg, 3, S, device="cpu")
    jcache = JT.init_cache(jcfg, 3, S)
    got, want = [], []
    with torch.no_grad():
        for slot, prompt in prompts.items():
            lg, cache = _admit(p, cfg, cache, slot, prompt, C, port)
            jlg, jcache = _admit(
                jp, jcfg, jcache, slot, prompt, C,
                lambda p_, c, ch, sl, s: ref(p_, c, jnp.asarray(ch,
                                                               jnp.int32),
                                             sl, jnp.asarray(s, jnp.int32)))
            got += lg
            want += jlg
    return cache, jcache, got, want


def test_admission_into_slots_then_decode_matches_reference(arch):
    cfg, jcfg, p, jp, atol = arch
    cache, jcache, got, want = _admitted(arch)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=atol)
    _caches_close(cache, jcache, cfg, atol)
    toks = np.array([[0], [7], [9]], np.int64)
    off = np.array([S - 1, 10, 3], np.int32)
    with torch.no_grad():
        lg, cache = T.decode_step(p, cfg, torch.from_numpy(toks), cache,
                                  torch.from_numpy(off))
    jlg, jcache = JT.decode_step(jp, jcfg, jnp.asarray(toks, jnp.int32),
                                 jcache, jnp.asarray(off))
    np.testing.assert_allclose(lg[1:].numpy(), np.asarray(jlg)[1:], rtol=0,
                               atol=atol)


def test_slot_surgery(arch):
    cfg, jcfg, p, jp, _ = arch
    cache, jcache, _, _ = _admitted(arch)
    # the kind-blind ops, bit for bit the reference's on the same cache
    jl = lambda c: weights.unstack_layers(jax.tree.map(np.asarray, c), cfg,
                                          device="cpu")
    mine = jl(jcache)
    sub = T.take_slot(mine, 1)
    jsub = JT.take_slot(jcache, 1)
    for a, b in zip(sub, jl(jsub)):
        for k in b:
            assert torch.equal(a[k], b[k])
    T.write_slot(mine, [{k: x.clone() for k, x in layer.items()}
                        for layer in T.take_slot(mine, 2)], 0)
    jw = JT.write_slot(jcache, JT.take_slot(jcache, 2), 0)
    T.reset_slot(mine, 2)
    jw = JT.reset_slot(jw, 2)
    for a, b in zip(mine, jl(jw)):
        for k in b:
            assert torch.equal(a[k], b[k])
    # resetting slot 1 leaves slots 0 and 2 bit for bit
    toks = torch.tensor([[4], [7], [9]])
    off = torch.tensor([S - 1, 10, 3], dtype=torch.int32)
    with torch.no_grad():
        before, cache = T.decode_step(p, cfg, toks, cache, off)
        T.reset_slot_state(cfg, cache, slot=1)
        assert all(not x[1].any() for layer in cache for x in layer.values())
        after, cache = T.decode_step(p, cfg, toks, cache, off)
    assert torch.equal(before[0], after[0])
    assert torch.equal(before[2], after[2])
    assert not torch.equal(before[1], after[1])


def _spec(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, cfg.vocab_size, 9).tolist(), g, 0.0)
            for i, g in enumerate([6, 3, 5, 4])]


def test_contiguous_paged_and_wave_token_identical(arch):
    cfg, jcfg, p, jp, _ = arch
    spec = _spec(cfg)
    base = dict(max_slots=2, max_len=S, prefill_chunk=4, chunks_per_step=2,
                temperature=0.8, seed=11)
    contig = ServeEngine(cfg, p, EngineConfig(**base))
    assert contig.plan.describe() == f"{cfg.num_layers}×contiguous"
    out = contig.run([Request(*r) for r in spec])
    paged = ServeEngine(cfg, p, EngineConfig(kv_mode="paged", block_size=4,
                                             **base))
    wave, wm = serve_waves(cfg, p, EngineConfig(**base),
                           [Request(*r) for r in spec])
    assert out == paged.run([Request(*r) for r in spec]) == wave
    assert wm.summary()["completed"] == 4
    assert contig.metrics.summary()["completed"] == 4
    assert all(len(out[i]) == g for i, _, g, _ in spec)


def test_greedy_contiguous_engine_matches_reference(arch):
    cfg, jcfg, p, jp, _ = arch
    spec = [(i, pr, g, a) for (i, pr, g, _), a in
            zip(_spec(cfg, 4), [0.0, 0.0, 0.01, 0.05])]
    base = dict(max_slots=2, max_len=S, prefill_chunk=4, chunks_per_step=2)
    ours = ServeEngine(cfg, p, EngineConfig(**base))
    theirs = JServeEngine(jcfg, jp, JEngineConfig(**base))
    assert theirs.ecfg.kv_mode == ours.ecfg.kv_mode == "contiguous"
    assert ours.run([Request(*r) for r in spec]) == \
        theirs.run([JRequest(*r) for r in spec])
    assert ours.metrics.summary() == theirs.metrics.summary()
