"""Port parity: the frontend architectures (paligemma-3b with its prefix-LM,
musicgen-medium with sinusoidal positions), on the CPU.

At smoke size in f32, on the reference's params carried over by
``weights.from_jax_params``, against ``repro``:

  * ``get_config`` field by field and ``count_params`` (total and active)
    for the full configs and their smoke variants, and the published
    counts the card phases are sized by;
  * ``SyntheticLM``'s frontend batches bit for bit (steps 0 and 1, one
    host and two);
  * ``layers.sinusoidal_pos`` for 1-D and ``[B, T]`` positions up to
    4096, each element within ``2e-6 + 6e-8 * position``: XLA's f32
    ``exp`` is not correctly rounded (10 of paligemma-smoke's 64
    frequencies are an ulp off the rounded exact value, torch's 1), so a
    frequency may differ by one ulp (<= 6e-8 below 1) and the angle by
    the position times that; ``sin``/``cos`` of equal angles agree within
    2e-6;
  * ``forward``'s logits with frontend embeddings within 2e-5 (the dense
    models' bound, ``tests/test_torch_configs_attn.py``: the same
    arithmetic summed in other orders);
  * paligemma's prefix-LM at 2048 positions and more, where the attention
    takes the blocked path (checkpointed query blocks of 512): with the
    published smoke prefix of 8 and with a prefix of 600, whose rounded-up
    ``pre_hi`` (1024) widens the first query block past its diagonal;
    against the reference's ``forward`` and against the port's own
    unblocked attention, within 2e-5;
  * ``prefill`` (its last logits and its offset ``Tf + k``) and then
    ``decode_step``s over the contiguous cache, against the reference's
    same calls within 2e-5 and against the port's own ``forward`` within
    the reference's ``test_decode_matches_forward`` bound;
  * ``loss_fn``'s loss and every gradient leaf against
    ``jax.value_and_grad`` (``frontend_proj`` included, and nonzero), with
    the bounds of ``tests/test_torch_train_moe.py``;
  * the reference's bidirectional-prefix check, and causality over text;
  * the port's ``ServeEngine`` and ``launch.serve`` refuse both archs with
    the reference's ``ValueError``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import layers as JL
from repro.models import registry as JR
from repro.models import transformer as JT
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch import weights
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import serve as serve_cli
from repro_torch.models import layers as L
from repro_torch.models import registry as R
from repro_torch.models import transformer as T
from repro_torch.serve import EngineConfig, ServeEngine

from test_torch_train_moe import assert_train_parity

ARCHS = ["paligemma-3b", "musicgen-medium"]
ATOL = 2e-5
SIN_ATOL = 2e-6          # sin/cos of equal f32 angles
FREQ_ULP = 6e-8          # one ulp of a frequency in (0.5, 1]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops, which a thread pool per worker only slows when the
    suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(name, **cut):
    cfg, jcfg = R.get_config(name), JR.get_config(name)
    if cut:
        cfg, jcfg = (dataclasses.replace(c, **cut) for c in (cfg, jcfg))
    jp = JT.init_params(jcfg, jax.random.key(0))
    p = weights.from_jax_params(jax.tree.map(np.asarray, jp), cfg,
                                device="cpu")
    return cfg, jcfg, p, jp


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return _pair(request.param + "-smoke")


def _inputs(cfg, B, Tlen, seed=1):
    """Tokens and frontend embeddings as the reference's smoke tests make
    them (embeddings scaled by 0.1)."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, Tlen)).astype(np.int32)
    fe = (rng.standard_normal((B, cfg.frontend_tokens, cfg.frontend_dim))
          * 0.1).astype(np.float32)
    return tok, fe


def _forward(p, cfg, tok, fe):
    with torch.no_grad():
        return T.forward(p, cfg, torch.from_numpy(tok),
                         torch.from_numpy(fe)).numpy()


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
    pali, mg = R.get_config("paligemma-3b"), R.get_config("musicgen-medium")
    assert R.count_params(pali) == 2_511_022_080
    assert R.count_params(mg) == 1_366_574_592
    cut = dataclasses.replace(pali, num_layers=6, layer_pattern=("attn",) * 6)
    assert R.count_params(cut) == 1_189_767_168
    assert (pali.prefix_lm, pali.frontend_tokens, pali.num_kv_heads) == \
        (True, 256, 1)
    assert (mg.pos_embed, mg.frontend_tokens, mg.prefix_lm) == \
        ("sinusoidal", 64, False)


def test_frontend_proj_sits_at_the_reference_leaf_position(arch):
    cfg, _, p, jp = arch
    paths = [leaf.path for leaf in weights.reference_leaves(p, cfg)]
    jpaths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert paths == jpaths
    assert paths.index("frontend_proj/w") == 2
    assert tuple(p["frontend_proj"]["w"].shape) == \
        (cfg.frontend_dim, cfg.d_model)
    meta = T.init_params(cfg, device="meta")
    assert tuple(meta["frontend_proj"]["w"].shape) == \
        (cfg.frontend_dim, cfg.d_model)


@pytest.mark.parametrize("hosts", [1, 2])
@pytest.mark.parametrize("name", [a + "-smoke" for a in ARCHS])
def test_synthetic_frontend_batches_bit_for_bit(name, hosts):
    cfg, jcfg = R.get_config(name), JR.get_config(name)
    for host in range(hosts):
        ours = SyntheticLM(cfg, DataConfig(global_batch=4, seq_len=16,
                                           seed=3, num_hosts=hosts,
                                           host_id=host))
        ref = JSyntheticLM(jcfg, JDataConfig(global_batch=4, seq_len=16,
                                             seed=3, num_hosts=hosts,
                                             host_id=host))
        for step in (0, 1):
            a, b = ours.batch(step), ref.batch(step)
            assert sorted(a) == sorted(b) == ["frontend", "labels", "tokens"]
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
            assert a["frontend"].shape == \
                (4 // hosts, cfg.frontend_tokens, cfg.frontend_dim)


@pytest.mark.parametrize("shape", [(300,), (3, 17)], ids=["1d", "BT"])
def test_sinusoidal_pos_matches_reference(shape):
    pos = np.random.default_rng(0).integers(0, 4096, shape).astype(np.int32)
    got = L.sinusoidal_pos(torch.from_numpy(pos), 128)
    want = np.asarray(JL.sinusoidal_pos(jnp.asarray(pos), 128))
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = np.abs(got.numpy() - want)
    assert np.all(err <= SIN_ATOL + FREQ_ULP * pos[..., None]), \
        float((err - FREQ_ULP * pos[..., None]).max())
    # position 0: sin 0 and cos 0 exactly; small positions to float noise
    zero = L.sinusoidal_pos(torch.zeros(1, dtype=torch.int32), 128)[0]
    assert torch.equal(zero, torch.cat([torch.zeros(64), torch.ones(64)]))
    small = pos < 64
    np.testing.assert_allclose(got.numpy()[small], want[small], rtol=0,
                               atol=1e-5)


def test_forward_matches_reference(arch):
    cfg, jcfg, p, jp = arch
    tok, fe = _inputs(cfg, 2, 11)
    got = _forward(p, cfg, tok, fe)
    want = np.asarray(JT.forward(jp, jcfg, jnp.asarray(tok),
                                 jnp.asarray(fe)))
    assert got.shape == (2, cfg.frontend_tokens + 11, cfg.vocab_size)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("prefix", [8, 600])
def test_prefix_lm_blocked_path_matches_reference(prefix, monkeypatch):
    """2048 positions (prefix + text) take the blocked attention path in
    both packages; the port's blocks (counted) match the reference's
    forward and the port's own unblocked attention."""
    cfg, jcfg, p, jp = _pair("paligemma-3b-smoke", frontend_tokens=prefix)
    tok, fe = _inputs(cfg, 1, L.QUERY_CHUNK_THRESHOLD - prefix, seed=2)
    blocks = []
    query_block = L._query_block

    def counted(*args, **kw):
        blocks.append((args[0], args[1]))
        return query_block(*args, **kw)

    monkeypatch.setattr(L, "_query_block", counted)
    got = _forward(p, cfg, tok, fe)
    # each layer reads keys [0, hi) per block: the first block up to
    # pre_hi, the prefix rounded up to a block
    pre_hi = -(-prefix // L.QUERY_CHUNK) * L.QUERY_CHUNK
    assert blocks[:4] == [(0, max(512, pre_hi)), (0, max(1024, pre_hi)),
                          (0, 1536), (0, 2048)]
    assert len(blocks) == 4 * cfg.num_layers
    want = np.asarray(JT.forward(jp, jcfg, jnp.asarray(tok),
                                 jnp.asarray(fe)))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    monkeypatch.setattr(L, "QUERY_CHUNK_THRESHOLD", 1 << 30)
    blocks.clear()
    plain = _forward(p, cfg, tok, fe)
    assert not blocks
    np.testing.assert_allclose(got, plain, rtol=0, atol=ATOL)


def test_prefill_then_decode_matches_reference_and_forward(arch):
    """The reference's ``test_decode_matches_forward`` on both packages:
    prefill ``t[:k]`` after the frontend, then decode ``t[k:]`` one token
    a step at offsets ``Tf + i`` (musicgen's sinusoid at those offsets)."""
    cfg, jcfg, p, jp = arch
    B, Tlen, k = 2, 12, 7
    tok, fe = _inputs(cfg, B, Tlen)
    full = _forward(p, cfg, tok, fe)
    off0 = cfg.frontend_tokens
    S = Tlen + off0 + 2
    cache = T.init_cache(cfg, B, S, device="cpu")
    jcache = JT.init_cache(jcfg, B, S)
    with torch.no_grad():
        lg, cache, off = T.prefill(p, cfg, torch.from_numpy(tok[:, :k]),
                                   cache, torch.from_numpy(fe))
    jlg, jcache, joff = JT.prefill(jp, jcfg, jnp.asarray(tok[:, :k]),
                                   jcache, jnp.asarray(fe))
    assert off == int(joff) == off0 + k
    got, want, ref = [lg.numpy()[:, 0]], [full[:, off0 + k - 1]], \
        [np.asarray(jlg)[:, 0]]
    for i in range(k, Tlen):
        with torch.no_grad():
            lg, cache = T.decode_step(p, cfg, torch.from_numpy(
                tok[:, i:i + 1]), cache, i + off0)
        jlg, jcache = JT.decode_step(jp, jcfg, jnp.asarray(tok[:, i:i + 1]),
                                     jcache, jnp.asarray(i + off0, jnp.int32))
        got.append(lg.numpy()[:, 0])
        want.append(full[:, off0 + i])
        ref.append(np.asarray(jlg)[:, 0])
    got, want, ref = np.stack(got), np.stack(want), np.stack(ref)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    scale = np.abs(want).max() + 1e-6
    np.testing.assert_allclose(got, want, atol=2e-3 * scale, rtol=2e-2)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            cache[0][name].numpy(),
            np.asarray(jcache[0]["l0"][name])[0], rtol=0, atol=ATOL)


def test_loss_and_grads_match_reference(arch):
    cfg = arch[0]
    tok, fe = _inputs(cfg, 2, 24, seed=4)
    labels = np.roll(tok, -1, axis=1)
    labels[0, :3] = -1
    batch = {"tokens": tok, "labels": labels, "frontend": fe}
    metrics = assert_train_parity(cfg.name, arch[3], batch)
    assert set(metrics) == {"xent", "aux"}
    params = weights.from_jax_params(jax.tree.map(np.asarray, arch[3]), cfg,
                                     device="cpu")
    w = params["frontend_proj"]["w"].requires_grad_(True)
    loss, _ = T.loss_fn(params, cfg, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
    (g,) = torch.autograd.grad(loss, [w])
    assert g.abs().sum() > 0


def test_loss_covers_the_text_positions_only(arch):
    """The loss is the mean cross-entropy of the text positions of
    ``forward``'s logits: the frontend positions carry no label."""
    cfg, _, p, _ = arch
    tok, fe = _inputs(cfg, 2, 10, seed=5)
    labels = np.roll(tok, -1, axis=1)
    with torch.no_grad():
        loss, _ = T.loss_fn(p, cfg, {"tokens": torch.from_numpy(tok),
                                     "labels": torch.from_numpy(labels),
                                     "frontend": torch.from_numpy(fe)})
    logits = torch.from_numpy(_forward(p, cfg, tok, fe))
    text = logits[:, cfg.frontend_tokens:]
    want = torch.nn.functional.cross_entropy(
        text.reshape(-1, cfg.vocab_size),
        torch.from_numpy(labels).long().reshape(-1))
    assert abs(loss.item() - want.item()) <= 1e-5


def test_prefix_lm_bidirectional_and_causal_over_text():
    """The reference's check: changing the LAST prefix embedding moves
    position 0's logits; and changing a text token moves no earlier
    position (the prefix included)."""
    cfg, _, p, _ = _pair("paligemma-3b-smoke")
    tok, fe = _inputs(cfg, 1, 8)
    l1 = _forward(p, cfg, tok, fe)
    fe2 = fe.copy()
    fe2[:, -1] += 0.5
    l2 = _forward(p, cfg, tok, fe2)
    assert np.abs(l1[:, 0] - l2[:, 0]).max() > 1e-4
    cut = 5
    tok2 = tok.copy()
    tok2[:, cut] = (tok2[:, cut] + 7) % cfg.vocab_size
    l3 = _forward(p, cfg, tok2, fe)
    before = cfg.frontend_tokens + cut
    np.testing.assert_allclose(l3[:, :before], l1[:, :before], rtol=0,
                               atol=1e-6)
    assert np.abs(l3[:, before] - l1[:, before]).max() > 1e-4


def test_musicgen_positions_enter_through_the_embeddings():
    """No rope: the sinusoidal table is added to the embeddings over every
    position, the frontend prefix included (``_embed``)."""
    cfg, _, p, _ = _pair("musicgen-medium-smoke")
    tok, fe = _inputs(cfg, 2, 5)
    with torch.no_grad():
        h = T._embed(p, cfg, torch.from_numpy(tok), torch.from_numpy(fe))
        pre = torch.from_numpy(fe) @ p["frontend_proj"]["w"]
        emb = p["embed"][torch.from_numpy(tok).long()]
        pos = L.sinusoidal_pos(torch.arange(h.shape[1]), cfg.d_model)
    torch.testing.assert_close(h, torch.cat([pre, emb], 1) + pos)
    with torch.no_grad():
        row = T._embed(p, cfg, torch.from_numpy(tok[:, :1]),
                       positions=torch.tensor([[3], [9]]))
    torch.testing.assert_close(row[:, 0], emb[:, 0] + pos[[3, 9]])


@pytest.mark.parametrize("name", [a + "-smoke" for a in ARCHS])
def test_serving_refuses_frontend_archs(name):
    cfg = R.get_config(name)
    msg = "frontend architectures are not servable"
    with pytest.raises(ValueError, match=msg):
        JServeEngine(JR.get_config(name), None, JEngineConfig())
    with pytest.raises(ValueError, match=msg):
        ServeEngine(cfg, None, EngineConfig())
    with pytest.raises(ValueError, match=msg):
        serve_cli.main(["--arch", name, "--device", "cpu", "--requests",
                        "2", "--prompt-len", "4", "--gen", "2"])
