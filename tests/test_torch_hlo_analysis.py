"""Port parity: ``launch/hlo_analysis.py``.

  * the HLO-text reader (``analyze_hlo``) ``==`` the reference's
    ``as_dict()`` on the reference test's ``SYNTHETIC`` module and on the
    optimized HLO of a compiled scan, of a sharded all-reduce on 8 host
    devices (a (2, 4) mesh, iota replica groups) and of the reference's dry
    run of gemma2-2b-smoke's train step on a (2, 4) mesh (while loops,
    all-gathers, reduce-scatters).  The texts come from one subprocess
    with 8 host devices (this file's ``__main__``);
  * ``_parse_groups`` ``==`` the reference's on every ``replica_groups``
    attribute of those texts and on the reference test's iota strings;
  * ``roofline_terms`` ``==`` the reference's under the reference's peaks
    (passed in as ``Peaks``); the default prices on the H100 SXM's
    data-sheet figures;
  * ``analyze_program`` (the port's reader of its own program) on a
    small program: FLOPs ``==`` ``torch.utils.flop_counter``'s, the dots,
    HBM bytes, transcendentals and the peak of live storage by hand, the
    inputs it reads, and the same counts on ``meta`` as on the CPU.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.launch import hlo_analysis as RH
from repro_torch.launch import hlo_analysis as H
from test_hlo_analysis import SYNTHETIC

ROOT = Path(__file__).resolve().parents[1]
TEXTS = ["scan", "allreduce", "dryrun_train"]


def reference_texts(out_dir: Path):
    """The HLO texts of the reference's compiled programs (8 host
    devices)."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.configs.base import ShapeSpec
    from repro.launch import dryrun as D
    from repro.launch.mesh import make_mesh

    def f(x, w):
        def body(h, wi):
            return h @ wi, ()
        return lax.scan(body, x, w)[0]

    x = jax.ShapeDtypeStruct((256, 256), jnp.float32)
    w8 = jax.ShapeDtypeStruct((8, 256, 256), jnp.float32)
    texts = {"scan": jax.jit(f).lower(x, w8).compile().as_text()}
    mesh = make_mesh((2, 4), ("data", "model"))
    g = jax.jit(lambda a: (a @ a.T).sum(1),
                in_shardings=NamedSharding(mesh, P("data", "model")),
                out_shardings=NamedSharding(mesh, P()))
    texts["allreduce"] = g.lower(
        jax.ShapeDtypeStruct((64, 128), jnp.float32)).compile().as_text()
    D._mesh = lambda kind: mesh
    D.SHAPE_BY_NAME["train_4k"] = ShapeSpec("train_4k", 64, 4, "train")
    _, compiled = D.lower_cell("gemma2-2b-smoke", "train_4k", "single")
    texts["dryrun_train"] = compiled.as_text()
    for name, text in texts.items():
        (out_dir / f"{name}.hlo").write_text(text)


@pytest.fixture(scope="module")
def hlo_texts(tmp_path_factory):
    out = tmp_path_factory.mktemp("hlo")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, __file__, str(out)], env=env, check=True,
                   cwd=ROOT, timeout=600)
    return {n: (out / f"{n}.hlo").read_text() for n in TEXTS}


def _texts(hlo_texts):
    return dict(hlo_texts, synthetic=SYNTHETIC)


@pytest.mark.parametrize("name", ["synthetic"] + TEXTS)
def test_analyze_hlo_equals_reference(hlo_texts, name):
    text = _texts(hlo_texts)[name]
    want = RH.analyze_hlo(text).as_dict()
    got = H.analyze_hlo(text).as_dict()
    assert got == want
    assert want["flops"] > 0
    if name in ("allreduce", "dryrun_train"):
        assert want["total_collective_bytes"] > 0


def test_parse_groups_equals_reference(hlo_texts):
    attrs = ["replica_groups=[2,4]<=[8]", "replica_groups=[4,2]<=[2,4]T(1,0)",
             "replica_groups={{0,1,2,3},{4,5,6,7}}", "replica_groups={}"]
    for text in _texts(hlo_texts).values():
        attrs += re.findall(r"replica_groups=(?:\[[^ ]*|\{[\d,{}\s]*\}\})",
                            text)
    assert len(attrs) > 8
    for a in attrs:
        assert H._parse_groups(a) == RH._parse_groups(a), a


def test_roofline_terms_equal_reference_under_its_peaks(hlo_texts):
    v5e = H.Peaks("v5e", flops=RH.PEAK_FLOPS, hbm=RH.HBM_BW, ici=RH.ICI_BW,
                  dcn=RH.DCN_BW)
    for text in _texts(hlo_texts).values():
        assert H.roofline_terms(H.analyze_hlo(text), v5e) == \
            RH.roofline_terms(RH.analyze_hlo(text))
    st = H.HloStats(flops=989e12, hbm_bytes=3.35e12 * 2)
    st.wire_bytes["ici"] = 450e9 * 0.5
    st.wire_bytes["dcn"] = 50e9 * 0.25
    t = H.roofline_terms(st)
    assert (t["compute_s"], t["memory_s"], t["collective_ici_s"],
            t["collective_dcn_s"]) == pytest.approx((1.0, 2.0, 0.5, 0.25))
    assert t["dominant"] == "memory_s" and t["bound_s"] == pytest.approx(2)


def _program(x, w, cache):
    """A matmul, a transcendental, an in-place whole overwrite of
    ``cache`` and a read of it after: 2 dots forward, 2 backward."""
    y = torch.tanh(x @ w)
    cache.copy_(y.detach())
    loss = (y * cache).sum()
    return torch.autograd.grad(loss, (x, w))


def _inputs(device):
    x = torch.ones(64, 128, device=device, requires_grad=True)
    w = torch.ones(128, 32, device=device, requires_grad=True)
    return x, w, torch.zeros(64, 32, device=device)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_analyze_program_counts(device):
    x, w, cache = _inputs(device)
    with H.ProgramCounter((x, w, cache)) as pc:
        _program(x, w, cache)
    st = pc.stats
    with FlopCounterMode(display=False) as fc:
        _program(*_inputs(device))
    assert st.flops == fc.get_total_flops() == 3 * 2 * 64 * 128 * 32
    assert st.dot_count == 3                        # x @ w, then dx and dw
    assert st.transcendentals == 64 * 32            # tanh
    assert st.input_bytes == 4 * (64 * 128 + 128 * 32 + 64 * 32)
    # x, w, cache, then y, dx and dw at once at least
    assert st.peak_live_bytes >= st.input_bytes + 4 * (64 * 32 + 64 * 128
                                                       + 128 * 32)
    assert st.hbm_bytes >= 4 * (64 * 128 + 128 * 32 + 64 * 32)
    # the cache is overwritten whole before it is read: jax would drop it
    assert pc.read == {H.storage_key(x), H.storage_key(w)}
    d = st.as_dict()
    assert "f32_upcast_copy_bytes" not in d and d["wire_bytes"] == {}


def test_analyze_program_same_on_meta_and_cpu():
    got = {}
    for device in ("cpu", "meta"):
        st = H.analyze_program(_program, *_inputs(device))
        got[device] = st.as_dict()
    assert got["cpu"] == got["meta"]


def test_h100_peaks_are_the_data_sheet_figures():
    p = H.H100_SXM
    assert (p.flops, p.hbm, p.ici, p.dcn) == (989e12, 3.35e12, 450e9, 50e9)
    src = (ROOT / "src/repro_torch/launch/hlo_analysis.py").read_text()
    for tpu in ("197e12", "819e9"):
        assert tpu not in src


if __name__ == "__main__":
    reference_texts(Path(sys.argv[1]))
