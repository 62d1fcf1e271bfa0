"""Port parity: the paged serve engine end to end on the CPU.

The port's paged ``ServeEngine`` against the reference's paged ``ServeEngine`` on
gemma2-2b-smoke with the reference's params, greedy decoding and the
virtual step clock: outputs must be token-identical and the whole metrics
summary (TTFTs, decode steps, preemptions, prefix hits, block gauges)
equal.  The port's "ref" lowering is held to the reference's "ref", and
its "auto" route (``kernels.paged_attention``: ref.py on CPU tensors) to
the reference's Pallas kernel in interpret mode.  Random-init smoke models
decode near-constant sequences, so token identity is backed by the logit
tolerances of ``test_torch_transformer.py``.
"""

import jax
import numpy as np
import pytest

from repro.models import transformer as JT
from repro.models.registry import get_config as jax_get_config
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch import weights
from repro_torch.kernels.paged_attention import ops
from repro_torch.launch import serve as serve_cli
from repro_torch.models.registry import get_config
from repro_torch.serve import EngineConfig, Request, ServeEngine

ARCH = "gemma2-2b-smoke"


@pytest.fixture(scope="module")
def cfgs():
    return get_config(ARCH), jax_get_config(ARCH)


@pytest.fixture(scope="module")
def params(cfgs):
    cfg, jcfg = cfgs
    jp = JT.init_params(jcfg, jax.random.key(0))
    return weights.from_jax_params(jax.tree.map(np.asarray, jp), cfg,
                                   device="cpu"), jp


def _requests(vocab, lens, gens, seed=0, arrivals=None, prompts=None):
    rng = np.random.default_rng(seed)
    if prompts is None:
        prompts = [rng.integers(0, vocab, size=(n,)).tolist() for n in lens]
    arrivals = arrivals or [0.0] * len(prompts)
    return [(i, p, g, a) for i, (p, g, a) in
            enumerate(zip(prompts, gens, arrivals))]


def _serve(cfgs, params, spec, port_kernel="ref", jax_kernel="ref", **kw):
    """Run both engines on the same requests; returns (ours, theirs) as
    (results, summary)."""
    cfg, jcfg = cfgs
    p, jp = params
    base = dict(max_slots=2, max_len=24, prefill_chunk=4, chunks_per_step=2,
                block_size=4)
    base.update(kw)
    ours = ServeEngine(cfg, p, EngineConfig(kv_mode="paged",
                                            paged_kernel=port_kernel,
                                            **base))
    theirs = JServeEngine(jcfg, jp, JEngineConfig(
        kv_mode="paged", paged_kernel=jax_kernel, **base))
    out = ours.run([Request(*r) for r in spec])
    jout = theirs.run([JRequest(*r) for r in spec])
    return (out, ours.metrics.summary()), (jout, theirs.metrics.summary())


def _assert_same(a, b):
    (out, summ), (jout, jsumm) = a, b
    assert out == jout
    assert summ == jsumm


@pytest.mark.parametrize("port_kernel,jax_kernel", [("ref", "ref"),
                                                    ("auto", "pallas")])
def test_ragged_budgets_token_identical(cfgs, params, port_kernel,
                                        jax_kernel):
    spec = _requests(512, [5, 9, 3, 12, 7], [6, 3, 8, 5, 4],
                     arrivals=[0.0, 0.0, 0.01, 0.05, 0.05])
    ours, theirs = _serve(cfgs, params, spec, port_kernel, jax_kernel)
    _assert_same(ours, theirs)
    assert ours[1]["completed"] == 5 and ours[1]["decode_steps"] > 0


def test_shared_prefix_cow_token_identical(cfgs, params):
    """Identical prompts admitted one after another: the second maps the
    published prefix blocks and copy-on-writes the block its right-aligned
    tail chunk rewrites."""
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, 512, size=(10,)).tolist()
    spec = _requests(512, None, [4, 5, 3], prompts=[prompt, prompt, prompt],
                     arrivals=[0.0, 0.2, 0.4])
    ours, theirs = _serve(cfgs, params, spec, max_slots=3)
    _assert_same(ours, theirs)
    assert ours[1]["prefix_hit_tokens"] > 0


def test_preemption_token_identical(cfgs, params):
    """A pool too small for both requests' growth: the youngest request is
    preempted and re-served, and outputs and accounting still agree."""
    spec = _requests(512, [6, 6, 5], [12, 12, 10], seed=4)
    ours, theirs = _serve(cfgs, params, spec, kv_blocks=7, max_len=20,
                          prefill_chunk=4)
    _assert_same(ours, theirs)
    assert ours[1]["preemptions"] > 0


def test_eos_stops_at_first_occurrence(cfgs, params):
    """EOS is a token whose first occurrence in a greedy output is at index
    >= 1 (a random-init model can repeat its first token, which would end
    the request at length 1); both engines must then stop there."""
    cfg, _ = cfgs
    spec = _requests(512, [5, 7, 4], [8, 8, 8], seed=5)
    plain = ServeEngine(cfg, params[0], EngineConfig(
        max_slots=2, max_len=24, prefill_chunk=4, chunks_per_step=2,
        kv_mode="paged", block_size=4, paged_kernel="ref")).run(
            [Request(*r) for r in spec])
    eos = rid = None
    for r, out in sorted(plain.items()):
        for k in range(1, len(out)):
            if out[k] not in out[:k]:
                eos, rid = out[k], r
                break
        if eos is not None:
            break
    assert eos is not None, "no usable eos in the greedy output"
    ours, theirs = _serve(cfgs, params, spec, eos_id=eos)
    _assert_same(ours, theirs)
    first = theirs[0][rid].index(eos)
    assert first >= 1 and len(theirs[0][rid]) == first + 1


def test_sampling_independent_of_slot_count(cfgs, params):
    cfg, _ = cfgs
    p, _ = params
    spec = _requests(512, [5, 9, 3, 6], [6, 5, 7, 4], seed=6)
    outs = []
    for slots in (1, 2, 4):
        eng = ServeEngine(cfg, p, EngineConfig(
            max_slots=slots, max_len=24, prefill_chunk=4, kv_mode="paged",
            block_size=4, temperature=0.8, seed=11))
        outs.append(eng.run([Request(*r) for r in spec]))
    assert outs[0] == outs[1] == outs[2]
    greedy = ServeEngine(cfg, p, EngineConfig(
        max_slots=2, max_len=24, prefill_chunk=4, kv_mode="paged",
        block_size=4)).run([Request(*r) for r in spec])
    assert outs[0] != greedy


def test_engine_rejects_unported_modes(cfgs, params):
    """What stays unported raises: the reference's Pallas lowering name;
    the wave oracle refuses the paged cache, as the reference's CLI does;
    a mesh that the slot pool does not divide among raises the reference's
    ValueError (mesh sharding itself is ported)."""
    cfg, _ = cfgs
    p, _ = params
    cli = ["--arch", ARCH, "--device", "cpu"]
    with pytest.raises(ValueError, match="contiguous cache only"):
        serve_cli.main(cli + ["--mode", "wave", "--kv-mode", "paged"])
    with pytest.raises(SystemExit):
        serve_cli.main(cli + ["--kv-mode", "ring"])
    with pytest.raises(SystemExit):
        serve_cli.main(cli + ["--paged-kernel", "pallas"])
    with pytest.raises(ValueError, match="kv_mode"):
        ServeEngine(cfg, p, EngineConfig(kv_mode="ring"))
    with pytest.raises(ValueError, match="paged_kernel"):
        ServeEngine(cfg, p, EngineConfig(paged_kernel="pallas"))
    # mesh sharding is ported: a slot pool that does not divide among the
    # mesh's devices raises the reference's ValueError
    from repro_torch.launch.mesh import make_mesh
    with pytest.raises(ValueError, match="must divide across 4 devices"):
        ServeEngine(cfg, p, EngineConfig(max_slots=6),
                    mesh=make_mesh((4,), ("data",), device="cpu"))


def test_cli_serves_every_request_on_cpu(capsys):
    launches = ops.LAUNCHES
    results, metrics = serve_cli.main([
        "--arch", ARCH, "--device", "cpu", "--requests", "5",
        "--prompt-len", "6", "--gen", "5", "--gen-spread", "3",
        "--max-slots", "2", "--prefill-chunk", "4", "--block-size", "4"])
    assert sorted(results) == list(range(5))
    assert metrics.summary()["completed"] == 5
    assert ops.LAUNCHES == launches      # CPU tensors never launch
    assert "kernel launches: 0" in capsys.readouterr().out
    # --devices shards the slot batch (ported): the same outputs
    sharded, _ = serve_cli.main([
        "--arch", ARCH, "--device", "cpu", "--requests", "5",
        "--prompt-len", "6", "--gen", "5", "--gen-spread", "3",
        "--max-slots", "2", "--prefill-chunk", "4", "--block-size", "4",
        "--devices", "2"])
    assert "devices=2" in capsys.readouterr().out
    assert sharded == results
