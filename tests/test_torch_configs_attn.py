"""Port parity: the attention configs of slice 9 (qwen2.5-3b,
phi4-mini-3.8b, granite-34b, qwen3-moe-235b-a22b), on the CPU.

Each arch exercises branches no earlier port path ran: QKV bias and tied
embeddings (qwen2.5, phi4), MQA with the plain GELU MLP (granite), and
qk-norm with the softmax router, ``norm_topk`` and no shared expert
(qwen3-moe; DeepSeek-V3 took only the sigmoid router).

* ``get_config`` equals the reference's field by field, for the full
  config and its smoke variant, and so do ``count_params`` (total and
  active), ``embedding_params`` and the segments.
* On the reference's params (``weights.from_jax_params``), at smoke size
  in f32: the forward logits within atol 2e-5 (the same arithmetic
  summed in other orders; qwen3-moe's MoE layers add a softmax router and
  an expert combine, so 1e-4 there, as for DeepSeek-V3 in
  ``test_torch_serve_mla.py``), and a chunked paged prefill then three
  decode steps against the reference's ``prefill_chunk``/``decode_step``
  with the same tolerances.
* The port's paged engine is token-identical to the reference's, with the
  same metrics summary, with an EOS whose first occurrence in a greedy
  output is at index >= 1 (ROADMAP C1: random-init smoke models repeat
  their first token).
* qwen3-moe is served only: training it is refused (ROADMAP A10).
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
from repro_torch.models import registry as R
from repro_torch.models import transformer as T
from repro_torch.serve import EngineConfig, Request, ServeEngine

ARCHS = ["qwen2.5-3b", "phi4-mini-3.8b", "granite-34b",
         "qwen3-moe-235b-a22b"]
ATOL = {"qwen3-moe-235b-a22b": 1e-4}
DENSE_ATOL = 2e-5


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


@pytest.mark.parametrize("name", ARCHS + [a + "-smoke" for a in ARCHS])
def test_config_and_param_counts_match_reference(name):
    ours, ref = R.get_config(name), JR.get_config(name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.segments() == ref.segments()
    for active in (False, True):
        assert R.count_params(ours, active) == JR.count_params(ref, active)
    assert R.embedding_params(ours) == JR.embedding_params(ref)


def test_published_counts():
    """The numbers the card phases are sized by (chip_smoke.py)."""
    qwen = R.get_config("qwen2.5-3b")
    assert R.count_params(qwen) == 3_085_938_688
    for layers, n in ((10, 1_081_936_896), (2, 465_320_960)):
        cut = dataclasses.replace(qwen, num_layers=layers,
                                  layer_pattern=("attn",) * layers)
        assert R.count_params(cut) == n


def test_branches_under_test(arch):
    cfg = arch[0]
    base = cfg.name[:-len("-smoke")]
    want = {"qwen2.5-3b": (True, True, False, "swiglu"),
            "phi4-mini-3.8b": (False, True, False, "swiglu"),
            "granite-34b": (False, False, False, "gelu"),
            "qwen3-moe-235b-a22b": (False, False, True, "swiglu")}[base]
    assert (cfg.qkv_bias, cfg.tie_embeddings, cfg.qk_norm, cfg.mlp) == want
    if base == "qwen3-moe-235b-a22b":
        assert (cfg.moe.router, cfg.moe.norm_topk, cfg.moe.num_shared) == \
            ("softmax", True, 0)
    assert R.get_config(base).num_kv_heads == \
        {"qwen2.5-3b": 2, "phi4-mini-3.8b": 8, "granite-34b": 1,
         "qwen3-moe-235b-a22b": 4}[base]


def test_forward_matches_reference(arch):
    cfg, jcfg, p, jp, atol = arch
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 11))
    with torch.no_grad():
        got = T.forward(p, cfg, torch.from_numpy(toks))
    want = JT.forward(jp, jcfg, jnp.asarray(toks, jnp.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


def test_prefill_then_decode_matches_reference(arch):
    """Chunked paged prefill of two ragged prompts, then three batched
    decode steps (row 2 masked), through both packages."""
    cfg, jcfg, p, jp, atol = arch
    N, bs, n, C = 16, 4, 6, 4
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=(k,)) for k in (10, 3)]
    tables = np.zeros((3, n), np.int32)
    tables[0, :4] = [5, 2, 9, 12]
    tables[1, :2] = [7, 3]
    jprefill = jax.jit(lambda p_, t, c, o, bt: JT.prefill_chunk(
        p_, jcfg, t, c, o, block_tables=bt))
    jdecode = jax.jit(lambda p_, t, c, o, bt: JT.decode_step(
        p_, jcfg, t, c, o, block_tables=bt, paged_kernel="ref"))
    cache = T.init_paged_cache(cfg, N, bs, device="cpu")
    jcache = JT.init_paged_cache(jcfg, N, bs)
    with torch.no_grad():
        for row, prompt in enumerate(prompts):
            plen = len(prompt)
            starts = [0] if plen <= C else \
                list(range(0, plen - C, C)) + [plen - C]
            for s in starts:
                chunk = np.zeros((1, C), np.int64)
                part = prompt[s:s + C]
                chunk[0, :len(part)] = part
                tab = tables[row:row + 1]
                lg, cache = T.prefill_chunk(
                    p, cfg, torch.from_numpy(chunk), cache, s,
                    block_tables=torch.from_numpy(tab))
                jlg, jcache = jprefill(jp, jnp.asarray(chunk, jnp.int32),
                                       jcache, jnp.asarray(s, jnp.int32),
                                       jnp.asarray(tab))
                np.testing.assert_allclose(lg.numpy(), np.asarray(jlg),
                                           rtol=0, atol=atol)
        lengths = [10, 3]
        toks = np.array([[11], [17], [0]], np.int64)
        for _ in range(3):
            off = np.array(lengths + [n * bs - 1], np.int32)
            lg, cache = T.decode_step(p, cfg, torch.from_numpy(toks), cache,
                                      torch.from_numpy(off),
                                      block_tables=torch.from_numpy(tables))
            jlg, jcache = jdecode(jp, jnp.asarray(toks, jnp.int32), jcache,
                                  jnp.asarray(off), jnp.asarray(tables))
            np.testing.assert_allclose(lg[:2].numpy(), np.asarray(jlg)[:2],
                                       rtol=0, atol=atol)
            nxt = lg[:, 0].argmax(-1).numpy()
            toks = np.array([[nxt[0]], [nxt[1]], [0]], np.int64)
            lengths = [x + 1 for x in lengths]


def test_engine_token_identical_with_eos(arch):
    cfg, jcfg, p, jp, _ = arch
    rng = np.random.default_rng(0)
    spec = [(i, rng.integers(0, cfg.vocab_size, size=(k,)).tolist(), g, 0.0)
            for i, (k, g) in enumerate(zip([5, 9, 3], [6, 7, 5]))]
    base = dict(max_slots=2, max_len=24, prefill_chunk=4,
                chunks_per_step=2, block_size=4)
    plain = ServeEngine(cfg, p, EngineConfig(kv_mode="paged",
                                             paged_kernel="ref", **base)
                        ).run([Request(*r) for r in spec])
    eos = rid = None
    for r, out in sorted(plain.items()):
        for k in range(1, len(out)):
            if out[k] not in out[:k]:
                eos, rid = out[k], r
                break
        if eos is not None:
            break
    assert eos is not None, "no usable eos in the greedy output"
    ours = ServeEngine(cfg, p, EngineConfig(kv_mode="paged",
                                            paged_kernel="auto", eos_id=eos,
                                            **base))
    theirs = JServeEngine(jcfg, jp, JEngineConfig(
        kv_mode="paged", paged_kernel="ref", eos_id=eos, **base))
    out = ours.run([Request(*r) for r in spec])
    jout = theirs.run([JRequest(*r) for r in spec])
    assert out == jout
    assert ours.metrics.summary() == theirs.metrics.summary()
    first = out[rid].index(eos)
    assert first >= 1 and len(out[rid]) == first + 1


def test_training_moe_is_refused():
    cfg = R.get_config("qwen3-moe-235b-a22b-smoke")
    params = T.init_params(cfg, 0, device="cpu")
    batch = {"tokens": torch.zeros(1, 4, dtype=torch.int64),
             "labels": torch.zeros(1, 4, dtype=torch.int64)}
    with pytest.raises(NotImplementedError, match="MTP and MoE"):
        T.loss_fn(params, cfg, batch)
