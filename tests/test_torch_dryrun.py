"""Port parity: the dry run (``launch/dryrun.py``, ``launch/specs.py``).

The reference lowers and compiles each cell with XLA; the port traces one
call of the same step on ``meta`` tensors.  The reference's
``lower_cell`` runs once per module in a subprocess with 8 host devices
(this file's ``__main__``), with ``dryrun._mesh`` and ``SHAPE_BY_NAME``
patched to small meshes and shapes; the port's is patched alike.

  * ``specs``: every input's shape and dtype ``==`` ``jax.eval_shape``'s,
    leaf by leaf, for every smoke arch and shape kind;
  * per-device argument bytes ``==`` the reference's
    ``memory_analysis()`` on (1, 1) and (2, 4) meshes (4,341,252 for
    gemma2-2b-smoke's train step on 4 x 64 at (1, 1)), arguments the
    program never reads left out as jax's ``jit`` drops them; output
    bytes ``==`` the reference's less its 8-byte pointer per output leaf
    (XLA's output tuple);
  * ``status``/``reason`` for every arch x shape ``==``;
  * ``params_*`` and ``model_flops_*`` ``==``;
  * the traced FLOPs against the reference's trip-count-corrected HLO
    FLOPs at (1, 1): decode and prefill ``==`` (gemma2-2b-smoke's decode
    3,407,872).  Train ``==`` at two loss chunks; at ONE chunk the port
    counts exactly one more ``[B·T, D] @ [D, V]`` product, 2·B·T·D·V =
    2^25: the checkpointed loss chunk recomputes its logits in the
    backward, and XLA merges that recompute with the forward's product
    when the chunk scan has a single trip (ROADMAP C12);
  * the levers (``remat``, ``loss_chunk``, ``query_chunk``,
    ``seq_shard``) and the activation policy are restored after a cell;
  * the CLI writes ``ok`` records for production cells on both meshes
    without importing jax or the reference.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import cell_applicable as jcell_applicable
from repro.launch import specs as JSP
from repro.models import registry as JR
from repro_torch.configs.base import SHAPES, ShapeSpec
from repro_torch.launch import dryrun as D
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import act_sharding as ACT
from repro_torch.models import layers as LYR
from repro_torch.models import registry as R
from repro_torch.models import sharding as SH
from repro_torch.models import transformer as T
from repro_torch.weights import reference_leaves

ROOT = Path(__file__).resolve().parents[1]
SMOKE = [a + "-smoke" for a in R.ARCH_IDS]
# (arch, shape name, kind, seq_len, global_batch, mesh, opts)
CELLS = [
    ("gemma2-2b-smoke", "train_4k", "train", 64, 4, (1, 1), {}),
    ("gemma2-2b-smoke", "train_4k", "train", 64, 4, (1, 1),
     {"loss_chunk": "32"}),
    ("gemma2-2b-smoke", "train_4k", "train", 64, 4, (2, 4), {}),
    ("gemma2-2b-smoke", "decode_32k", "decode", 128, 4, (1, 1), {}),
    ("gemma2-2b-smoke", "decode_32k", "decode", 128, 4, (2, 4), {}),
    ("gemma2-2b-smoke", "prefill_32k", "prefill", 32, 4, (1, 1), {}),
    ("qwen3-moe-235b-a22b-smoke", "train_4k", "train", 64, 4, (1, 1),
     {"loss_chunk": "32"}),
    ("deepseek-v3-671b-smoke", "decode_32k", "decode", 128, 4, (2, 4), {}),
    ("paligemma-3b-smoke", "prefill_32k", "prefill", 32, 4, (2, 4), {}),
    ("xlstm-1.3b-smoke", "long_500k", "decode", 256, 1, (2, 4), {}),
    ("jamba-v0.1-52b-smoke", "prefill_32k", "prefill", 32, 4, (1, 1), {}),
]
IDS = [f"{c[0]}:{c[1]}:{c[5][0]}x{c[5][1]}:{len(c[6])}" for c in CELLS]


def reference_records(path):
    from repro.configs.base import ShapeSpec as JShape
    from repro.launch import dryrun as JD
    from repro.launch.mesh import make_mesh
    out = []
    for arch, shape, kind, S, B, mesh, opts in CELLS:
        JD._mesh = lambda k, mesh=mesh: make_mesh(mesh, ("data", "model"))
        JD.SHAPE_BY_NAME[shape] = JShape(shape, S, B, kind)
        rec, _ = JD.lower_cell(arch, shape, "single", dict(opts))
        out.append(rec)
    Path(path).write_text(json.dumps(out))


CLI = """
import sys
from pathlib import Path
from repro_torch.launch import dryrun as D
D.RESULTS = Path(sys.argv[1])
rc = max(D.main(["--cell", cell, "--mesh", "both"]) for cell in sys.argv[2:])
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")]
assert not bad, bad
sys.exit(rc)
"""
CLI_CELLS = ("xlstm-1.3b:long_500k", "deepseek-v3-671b:decode_32k")


@pytest.fixture(scope="module", autouse=True)
def _procs(tmp_path_factory):
    """The reference's records and the port's CLI, both started at once
    (each a subprocess) while the in-process tests run."""
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    ref = subprocess.Popen(
        [sys.executable, __file__, str(tmp / "ref.json")], cwd=ROOT,
        env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8",
                 JAX_PLATFORMS="cpu"))
    cli = subprocess.Popen([sys.executable, "-c", CLI, str(tmp / "cli")]
                           + list(CLI_CELLS), cwd=ROOT, env=env)
    yield {"ref": (ref, tmp / "ref.json"), "cli": (cli, tmp / "cli")}
    ref.kill()
    cli.kill()


@pytest.fixture(scope="module")
def ref_records(_procs):
    proc, path = _procs["ref"]
    assert proc.wait(timeout=600) == 0
    return json.loads(path.read_text())


def port_record(cell, monkeypatch):
    arch, shape, kind, S, B, mesh, opts = cell
    monkeypatch.setattr(D, "_mesh", lambda k: Mesh(
        mesh, ("data", "model"), device=torch.device("meta")))
    monkeypatch.setitem(D.SHAPE_BY_NAME, shape, ShapeSpec(shape, S, B, kind))
    return D.lower_cell(arch, shape, "single", dict(opts))[0]


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


def _jleaves(tree):
    return [(tuple(l.shape), str(l.dtype)) for l in jax.tree.leaves(tree)]


def _tleaves(tensors):
    return [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for t in tensors]


@pytest.mark.parametrize("arch", SMOKE)
def test_specs_match_eval_shape(arch):
    cfg, jcfg = R.get_config(arch), JR.get_config(arch)
    jparams = JSP.params_specs(jcfg)
    params = SP.params_specs(cfg)
    assert all(t.device.type == "meta"
               for l in reference_leaves(params, cfg) for t in l.parts)
    assert [(l.shape, str(l.dtype).replace("torch.", ""))
            for l in reference_leaves(params, cfg)] == _jleaves(jparams)
    for kind, S, B in (("train", 64, 4), ("prefill", 32, 4),
                       ("decode", 128, 4)):
        shape = ShapeSpec(kind, S, B, kind)
        want = JSP.input_specs(jcfg, shape)
        got = SP.input_specs(cfg, shape)
        assert sorted(got) == sorted(want)
        for name in got:
            if name == "cache":
                leaves = SH.cache_leaves(got[name], cfg)
                assert [(l.shape, str(l.dtype).replace("torch.", ""))
                        for l in leaves] == _jleaves(want[name])
            elif name == "batch":
                assert sorted(got[name]) == sorted(want[name])
                for k in got[name]:
                    assert _tleaves([got[name][k]]) == \
                        _jleaves(want[name][k]), k
            else:
                assert _tleaves([got[name]]) == _jleaves(want[name]), name


# ---------------------------------------------------------------------------
# statuses, bytes, model FLOPs, traced FLOPs
# ---------------------------------------------------------------------------


def test_cell_status_for_every_arch_and_shape():
    assert [s.name for s in SHAPES] == [s.name for s in JSHAPES]
    for arch in R.ARCH_IDS:
        for shape, jshape in zip(SHAPES, JSHAPES):
            ok, why = jcell_applicable(JR.get_config(arch), jshape)
            assert D.cell_applicable(R.get_config(arch), shape) == (ok, why)
            if not ok:
                rec, trace = D.lower_cell(arch, shape.name, "multi")
                assert trace is None and rec == {"arch": arch, "shape": shape.name,
                               "mesh": "multi", "status": "skipped",
                               "reason": why}


@pytest.mark.parametrize("cell", CELLS, ids=IDS)
def test_record_matches_reference(ref_records, cell, monkeypatch):
    want = ref_records[CELLS.index(cell)]
    got = port_record(cell, monkeypatch)
    assert want["status"] == got["status"] == "ok"
    assert got["devices"] == want["devices"] == cell[5][0] * cell[5][1]
    for k in ("params_total", "params_active", "model_flops_global",
              "model_flops_per_device"):
        assert got[k] == want[k], k
    mem, jmem = got["memory"], want["memory"]
    assert mem["argument_size_in_bytes"] == jmem["argument_size_in_bytes"]
    assert mem["output_size_in_bytes"] + 8 * mem["output_leaves"] == \
        jmem["output_size_in_bytes"]
    flops, jflops = got["hlo_stats"]["flops"], want["hlo_stats"]["flops"]
    if cell[5] == (1, 1):
        arch, _, kind, S, B, _, opts = cell
        cfg = R.get_config(arch)
        one_chunk = kind == "train" and S <= int(opts.get("loss_chunk", 512))
        extra = 2 * B * S * cfg.d_model * cfg.vocab_size if one_chunk else 0
        assert flops == jflops + extra
    assert got["roofline"]["collective_s"] == 0.0
    assert got["useful_flops_ratio"] == round(
        got["model_flops_per_device"] / flops, 4)


def test_gemma_smoke_reference_numbers(ref_records, monkeypatch):
    """The numbers this port was first held to."""
    train = port_record(CELLS[0], monkeypatch)
    assert train["memory"]["argument_size_in_bytes"] == 4_341_252
    assert ref_records[0]["hlo_stats"]["flops"] == 771_751_936
    assert train["hlo_stats"]["flops"] - 771_751_936 == 2 ** 25
    assert port_record(CELLS[1], monkeypatch)["hlo_stats"]["flops"] == \
        ref_records[1]["hlo_stats"]["flops"] == 805_306_368
    assert port_record(CELLS[3], monkeypatch)["hlo_stats"]["flops"] == \
        ref_records[3]["hlo_stats"]["flops"] == 3_407_872


def test_production_meshes_on_meta():
    for multi, shape in ((False, (16, 16)), (True, (2, 16, 16))):
        m = make_production_mesh(multi_pod=multi, device="meta")
        assert m.device == torch.device("meta")
        assert tuple(m.shape.values()) == shape
        assert D._mesh("multi" if multi else "single").size == m.size
    assert make_production_mesh().device is None
    with pytest.raises(ValueError, match="abstract or on meta"):
        make_production_mesh(device="cpu")


def test_levers_are_restored_after_a_cell(monkeypatch):
    before = (T._REMAT, T.LOSS_CHUNK, LYR.QUERY_CHUNK, ACT.SEQ_SHARD,
              ACT._POLICY, ACT.SERVE_EP)
    opts = {"remat": "dots", "loss_chunk": "16", "query_chunk": "8",
            "seq_shard": "1"}
    seen = {}
    trace = D._trace

    def spy(*a):
        seen.update(remat=T._REMAT, chunk=T.LOSS_CHUNK, q=LYR.QUERY_CHUNK,
                    seq=ACT.SEQ_SHARD)
        return trace(*a)

    monkeypatch.setattr(D, "_trace", spy)
    cell = ("gemma2-2b-smoke", "train_4k", "train", 64, 4, (1, 1), opts)
    assert port_record(cell, monkeypatch)["status"] == "ok"
    assert seen == {"remat": "dots", "chunk": 16, "q": 8, "seq": True}
    assert (T._REMAT, T.LOSS_CHUNK, LYR.QUERY_CHUNK, ACT.SEQ_SHARD,
            ACT._POLICY, ACT.SERVE_EP) == before
    with pytest.raises(ValueError):
        port_record(cell[:6] + ({"remat": "bogus"},), monkeypatch)
    assert T._REMAT == before[0]


def test_a_trace_prices_the_cell_on_another_mesh(monkeypatch):
    calls = []
    trace = D._trace
    monkeypatch.setattr(D, "_trace", lambda *a: calls.append(a) or trace(*a))
    arch, shape, kind, S, B = "gemma2-2b-smoke", "decode_32k", "decode", 128, 4
    monkeypatch.setitem(D.SHAPE_BY_NAME, shape, ShapeSpec(shape, S, B, kind))
    recs = []
    tr = None
    for mesh in ((1, 1), (2, 4)):
        monkeypatch.setattr(D, "_mesh", lambda k, mesh=mesh: Mesh(
            mesh, ("data", "model"), device=torch.device("meta")))
        rec, got = D.lower_cell(arch, shape, "single", {}, tr)
        assert tr is None or got is tr
        tr = got
        recs.append(rec)
    assert len(calls) == 1
    assert [r["trace_reused"] for r in recs] == [False, True]
    assert recs[0]["global"] == recs[1]["global"]
    assert recs[1]["memory"]["argument_size_in_bytes"] < \
        recs[0]["memory"]["argument_size_in_bytes"]


def test_cli_writes_ok_records_without_jax(_procs):
    proc, tmp_path = _procs["cli"]
    assert proc.wait(timeout=600) == 0
    for mesh, n in (("single", 256), ("multi", 512)):
        recs = [json.loads((tmp_path / mesh / f).read_text()) for f in
                ("xlstm-1.3b__long_500k.json",
                 "deepseek-v3-671b__decode_32k.json")]
        for rec in recs:
            assert rec["status"] == "ok" and rec["devices"] == n
            assert rec["split"] == "even" and rec["peaks"] == "h100-sxm"
            assert rec["memory"]["argument_size_in_bytes"] > 0
            assert 0 < rec["useful_flops_ratio"]
            assert rec["roofline"]["bound_s"] > 0
            assert rec["hlo_stats"]["flops"] * n == pytest.approx(
                rec["global"]["flops"])
        assert recs[0]["trace_reused"] == (mesh == "multi")
    # one trace prices both meshes; the per-device bytes differ by mesh
    one = json.loads((tmp_path / "single" /
                      "deepseek-v3-671b__decode_32k.json").read_text())
    two = json.loads((tmp_path / "multi" /
                      "deepseek-v3-671b__decode_32k.json").read_text())
    assert one["global"] == two["global"]
    assert two["memory"]["argument_size_in_bytes"] < \
        one["memory"]["argument_size_in_bytes"]


if __name__ == "__main__":
    reference_records(sys.argv[1])
