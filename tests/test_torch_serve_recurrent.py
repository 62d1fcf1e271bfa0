"""Port parity: recurrent and hybrid serving (the SlotState protocol), on
the CPU.

The claims of the reference's ``tests/test_serve_slot_state.py``, held in
the port, at xlstm-1.3b-smoke (pure recurrent), jamba-v0.1-52b-smoke
(mamba + attention + MoE) and granite-34b-smoke (pure attention):

* wave-vs-continuous token identity under temperature sampling, with
  ``serve_waves`` as the oracle, for every backend mix: xlstm, granite,
  Jamba over contiguous and paged KV (``plan.describe() == "1×<mode> +
  7×recurrent"``) and Jamba under a mid-decode preemption, whose waste is
  booked exactly (``decode_tokens == (tokens_out - first_tokens) +
  wasted``);
* two-resource admission: with ``rec_slots`` 1 < ``max_slots`` the rows
  cap concurrency and outputs stay those of the roomy engine;
* recurrent archs never share prefix blocks (``prefix_lookup_tokens ==
  0``) and every row and block is back in its pool at the end;
* against the reference, with its parameters, in f32: the hybrid cache's
  masked chunked prefill into pooled rows and a decode step with a
  masked row on the sentinel row, logits and caches within ``ATOL`` (the
  recurrence's exp/log1p in two libraries, an ulp or so a step, through
  8 layers: ``test_torch_ssm.py``'s blocks agree within 2e-5); and the
  greedy engines' tokens and metrics summaries equal (ROADMAP C1: logits
  carry the weight, tokens are a second check).
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
from repro_torch.kernels.paged_attention import ops
from repro_torch.launch import serve as serve_cli
from repro_torch.models import registry as R
from repro_torch.models import transformer as T
from repro_torch.serve import (EngineConfig, NoFreeRows, RecurrentRows,
                               Request, ServeEngine, StatePlan, serve_waves)

JAMBA = "jamba-v0.1-52b-smoke"
XLSTM = "xlstm-1.3b-smoke"
ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops, which a thread pool per worker only slows when the
    suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS = {}


def _model(name):
    """(cfg, jcfg, port params, reference params), built once per arch."""
    if name not in _MODELS:
        cfg, jcfg = R.get_config(name), JR.get_config(name)
        jp = JT.init_params(jcfg, jax.random.key(0))
        _MODELS[name] = (cfg, jcfg, weights.from_jax_params(
            jax.tree.map(np.asarray, jp), cfg, device="cpu"), jp)
    return _MODELS[name]


def _requests(cfg, lens, gens, seed=0, cls=Request):
    rng = np.random.default_rng(seed)
    return [cls(req_id=i,
                prompt=rng.integers(0, cfg.vocab_size, size=(n,)).tolist(),
                max_new_tokens=g, arrival_s=0.0)
            for i, (n, g) in enumerate(zip(lens, gens))]


def _drive(eng, reqs, cap=5000):
    """Run the engine to drain with a step bound (deadlock detector)."""
    eng.submit(reqs)
    eng.metrics.start()
    steps = 0
    while len(eng.queue) or eng.table.busy():
        eng.step()
        steps += 1
        assert steps < cap, f"engine failed to drain within {cap} steps"
    eng.metrics.stop()
    return {r.req_id: eng.results[r.req_id] for r in reqs}


def _assert_drained(eng):
    if eng.rec is not None:
        eng.rec.assert_consistent()
        assert eng.rec.num_used == 0
    if eng.allocator is not None:
        assert eng.allocator.num_used == 0


def test_state_plan_and_rows():
    jcfg = R.get_config(JAMBA)
    plan = StatePlan.resolve(jcfg, "paged")
    assert plan.backends.count("recurrent") == 7
    assert plan.describe() == "1×paged + 7×recurrent"
    xplan = StatePlan.resolve(R.get_config(XLSTM), "contiguous")
    assert xplan.has_recurrent and not xplan.has_kv
    pool = RecurrentRows(2)
    assert [pool.alloc(), pool.alloc()] == [1, 2]
    with pytest.raises(NoFreeRows):
        pool.alloc()
    with pytest.raises(ValueError, match="recurrent cache"):
        T.init_paged_cache(jcfg, 4, 4, device="cpu")


@pytest.mark.parametrize("arch", [XLSTM, "granite-34b-smoke"])
def test_identity_single_backend(arch):
    """Prompt length 9 with chunk 4 forces a one-token masked tail on the
    recurrent path."""
    cfg, _, p, _ = _model(arch)
    ecfg = EngineConfig(max_slots=2, max_len=24, prefill_chunk=4,
                        temperature=0.8, seed=11)
    oracle, _ = serve_waves(cfg, p, ecfg,
                            _requests(cfg, [9] * 4, [5, 3, 4, 2], seed=1))
    eng = ServeEngine(cfg, p, ecfg)
    assert _drive(eng, _requests(cfg, [9] * 4, [5, 3, 4, 2], seed=1)) \
        == oracle
    _assert_drained(eng)


@pytest.mark.parametrize("kv_mode", ["contiguous", "paged"])
def test_identity_hybrid(kv_mode):
    cfg, _, p, _ = _model(JAMBA)
    ecfg = EngineConfig(max_slots=2, max_len=32, prefill_chunk=4,
                        temperature=0.7, seed=5, kv_mode=kv_mode,
                        block_size=8)
    oracle, _ = serve_waves(cfg, p, ecfg,
                            _requests(cfg, [10] * 4, [6, 4, 5, 3], seed=3))
    eng = ServeEngine(cfg, p, ecfg)
    assert eng.plan.describe() == f"1×{kv_mode} + 7×recurrent"
    launches = ops.LAUNCHES
    assert _drive(eng, _requests(cfg, [10] * 4, [6, 4, 5, 3], seed=3)) \
        == oracle
    assert ops.LAUNCHES == launches         # CPU tensors never launch
    _assert_drained(eng)
    if kv_mode == "paged":
        assert eng.metrics.summary()["blocks_peak"] > 0
        assert eng.metrics.peak_active > 0
        assert eng.metrics.prefix_lookup_tokens == 0


def test_identity_hybrid_under_preemption():
    cfg, _, p, _ = _model(JAMBA)
    ecfg = EngineConfig(max_slots=3, max_len=32, prefill_chunk=4,
                        chunks_per_step=4, temperature=0.6, seed=9,
                        kv_mode="paged", block_size=8, kv_blocks=8)
    mk = lambda: _requests(cfg, [14] * 3, [10, 10, 10], seed=7)
    oracle, _ = serve_waves(cfg, p, ecfg, mk())
    eng = ServeEngine(cfg, p, ecfg)
    out = _drive(eng, mk())
    s = eng.metrics.summary()
    assert s["preemptions"] > 0, "geometry was meant to force preemption"
    assert out == oracle
    _assert_drained(eng)
    assert s["decode_steps"] > 0 and s["wasted_decode_tokens"] > 0
    assert eng.metrics.decode_tokens == \
        (s["tokens_out"] - s["first_tokens"]) + s["wasted_decode_tokens"]


def test_two_resource_admission_rows_scarce():
    cfg, _, p, _ = _model(JAMBA)
    base = dict(max_slots=3, max_len=32, prefill_chunk=4, temperature=0.7,
                seed=5)
    mk = lambda: _requests(cfg, [8, 6, 10, 7], [5, 4, 6, 3], seed=2)
    e1 = ServeEngine(cfg, p, EngineConfig(**base))
    out1 = _drive(e1, mk())
    e2 = ServeEngine(cfg, p, EngineConfig(rec_slots=1, **base))
    assert e2.rec.capacity == 1
    assert _drive(e2, mk()) == out1
    assert e2.metrics.peak_active <= 1      # rows, not slots, set the cap
    e3 = ServeEngine(cfg, p, EngineConfig(
        rec_slots=1, kv_mode="paged", block_size=8, kv_blocks=7, **base))
    assert _drive(e3, mk()) == out1
    assert e3.metrics.peak_active <= 1
    for e in (e1, e2, e3):
        _assert_drained(e)


def test_hybrid_chunk_and_decode_match_reference():
    """Two pooled rows (1, 3) of four, prefilled through masked aligned
    chunks (row 3's prompt ends mid-chunk), then one decode step over
    slots (row 1, sentinel row 0 masked, row 3)."""
    cfg, jcfg, p, jp = _model(JAMBA)
    C, S = 4, 16
    rng = np.random.default_rng(4)
    prompts = {(0, 1): rng.integers(0, cfg.vocab_size, 8),
               (2, 3): rng.integers(0, cfg.vocab_size, 6)}
    cache = T.init_hybrid_cache(cfg, kv_batch=3, kv_len=S, rec_batch=4,
                                device="cpu")
    jcache = JT.init_hybrid_cache(jcfg, kv_batch=3, kv_len=S, rec_batch=4)

    @jax.jit
    def jadmit(c, chunk, slot, s, row, valid):
        sub = JT.take_state(jcfg, c, slot)
        lg, sub = JT.prefill_chunk(jp, jcfg, chunk, sub, s, rec_rows=row,
                                   valid=valid)
        return lg, JT.write_state(jcfg, c, sub, slot)

    with torch.no_grad():
        for (slot, row), prompt in prompts.items():
            for s in range(0, len(prompt), C):
                n = min(C, len(prompt) - s)
                chunk = np.zeros((1, C), np.int64)
                chunk[0, :n] = prompt[s:s + n]
                sub = T.take_state(cfg, cache, slot)
                lg, sub = T.prefill_chunk(
                    p, cfg, torch.from_numpy(chunk), sub, s,
                    rec_rows=torch.tensor([row]), valid=n)
                cache = T.write_state(cfg, cache, sub, slot)
                jlg, jcache = jadmit(jcache, jnp.asarray(chunk, jnp.int32),
                                     slot, jnp.asarray(s, jnp.int32),
                                     jnp.asarray([row], jnp.int32),
                                     jnp.asarray(n, jnp.int32))
                np.testing.assert_allclose(lg[0, :n].numpy(),
                                           np.asarray(jlg)[0, :n], rtol=0,
                                           atol=ATOL)
        toks = np.array([[3], [0], [5]], np.int64)
        off = np.array([8, S - 1, 6], np.int32)
        rows, act = np.array([1, 0, 3]), np.array([True, False, True])
        sentinel = [{k: x[0].clone() for k, x in layer.items()}
                    for layer in cache]
        lg, cache = T.decode_step(p, cfg, torch.from_numpy(toks), cache,
                                  torch.from_numpy(off),
                                  rec_rows=torch.from_numpy(rows),
                                  active=torch.from_numpy(act))
    jlg, jcache = JT.decode_step(jp, jcfg, jnp.asarray(toks, jnp.int32),
                                 jcache, jnp.asarray(off),
                                 rec_rows=jnp.asarray(rows, jnp.int32),
                                 active=jnp.asarray(act))
    np.testing.assert_allclose(lg[act].numpy(), np.asarray(jlg)[act],
                               rtol=0, atol=ATOL)
    jl = weights.unstack_layers(jax.tree.map(np.asarray, jcache), cfg,
                                device="cpu")
    for kind, got, want, sent in zip(cfg.layer_pattern, cache, jl,
                                     sentinel):
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=0, atol=ATOL, err_msg=k)
            if kind in T.REC_KINDS:         # the masked row wrote nothing
                assert torch.equal(got[k][0], sent[k])


@pytest.mark.parametrize("arch,kv_mode", [(XLSTM, "contiguous"),
                                          (JAMBA, "contiguous"),
                                          (JAMBA, "paged")])
def test_greedy_engine_matches_reference(arch, kv_mode):
    cfg, jcfg, p, jp = _model(arch)
    base = dict(max_slots=2, max_len=32, prefill_chunk=4, chunks_per_step=2,
                kv_mode=kv_mode, block_size=8)
    ours = ServeEngine(cfg, p, EngineConfig(**base))
    theirs = JServeEngine(jcfg, jp, JEngineConfig(**base))
    lens, gens = [9, 6, 11], [5, 4, 6]
    assert ours.run(_requests(cfg, lens, gens, seed=8)) == \
        theirs.run(_requests(cfg, lens, gens, seed=8, cls=JRequest))
    assert ours.metrics.summary() == theirs.metrics.summary()


def test_aligned_tail_past_max_len_follows_reference():
    """ROADMAP C8: over the contiguous cache a recurrent-bearing arch's
    aligned final chunk may run past ``max_len`` (prompt 20, chunk 16,
    max_len 23: [16, 32)); the write is clamped to [7, 23), over live
    positions, as the reference's ``dynamic_update_slice`` clamps it, so
    both engines leave the wave oracle there, the same way; the paged
    cache sends the overflow to the sentinel block and stays exact."""
    cfg, jcfg, p, jp = _model(JAMBA)
    spec = [(i, pr, 2, 0.0) for i, pr in enumerate(
        np.random.default_rng(0).integers(0, cfg.vocab_size,
                                          (2, 20)).tolist())]
    base = dict(max_slots=2, max_len=23, prefill_chunk=16)
    ours = ServeEngine(cfg, p, EngineConfig(**base)).run(
        [Request(*r) for r in spec])
    assert ours == JServeEngine(jcfg, jp, JEngineConfig(**base)).run(
        [JRequest(*r) for r in spec])
    oracle, _ = serve_waves(cfg, p, EngineConfig(**base),
                            [Request(*r) for r in spec])
    assert ours != oracle
    paged = ServeEngine(cfg, p, EngineConfig(
        kv_mode="paged", block_size=8, **dict(base, max_len=32))).run(
            [Request(*r) for r in spec])
    assert paged == oracle


@pytest.mark.parametrize("extra", [
    ["--arch", XLSTM, "--mode", "wave"],
    ["--arch", XLSTM],
    ["--arch", JAMBA, "--kv-mode", "paged", "--rec-slots", "1"],
])
def test_cli_serves_every_request_on_cpu(extra, capsys):
    results, metrics = serve_cli.main(extra + [
        "--device", "cpu", "--requests", "4", "--prompt-len", "6", "--gen",
        "4", "--max-slots", "2", "--prefill-chunk", "4", "--block-size",
        "4"])
    assert sorted(results) == list(range(4))
    assert metrics.summary()["completed"] == 4
    out = capsys.readouterr().out
    assert "paged_attention kernel launches: 0" in out
    if "--rec-slots" in extra:
        assert "1×paged + 7×recurrent (1 recurrent rows)" in out
        assert metrics.peak_active <= 1
