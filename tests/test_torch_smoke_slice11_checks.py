"""``chip_smoke.py``'s slice-11 checks, run on the CPU at smoke size.

* [5f] (``phase_train_xlstm``, here at xlstm-1.3b-smoke on the CPU with a
  decode-add that counts like the kernel wrappers): every bucket's int8
  hops are counted, steps x buckets x log2(4), and every bucket's real
  gradients reduce-scatter through the counted path and the plain
  versions alike; a wrapper that misses one bucket is rejected; a plan
  with no codec'd bucket adds one fixed int8 step, whose launches count;
* [5g]/[5h] (``phase_grads`` and its ``compare_grads``,
  ``check_loss_terms``): Jamba's and DeepSeek-V3's smoke configs in bf16
  against the same params in f32 pass; the comparison rejects a gradient
  with one leaf zeroed, a loss that is not the sum of its terms, and an
  expert that no token picked but whose weights got a gradient.

The smoke pair is held to ``SMOKE_BOUNDS``, looser than the card's
published-width bounds: at width 128 and 8 layers a bf16 gradient of a
small leaf (mamba's ``A_log``, a router) is a sum of few terms and reads
cosines down to 0.87 against f32 on the CPU.  The ``cuda``-marked tests
run the three phases at smoke size on the card and skip here.
"""

import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.core import collectives
from repro_torch.kernels.tree_reduce import ops as tops, ref as tref
from repro_torch.models import layers as L
from repro_torch.models.registry import get_config
from repro_torch.optim.compression import Bf16Codec, Int8Codec
from repro_torch.runtime.trainer import _map_tensors
from test_torch_smoke_slice9_checks import _counting

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
XLSTM = "xlstm-1.3b-smoke"
STEPS = 2
CODECS = {"bf16": Bf16Codec(), "int8": Int8Codec()}
SMOKE_BOUNDS = dict(loss=0.05, cos=0.75, rel=0.75)
GRAD_ARCHS = ["jamba-v0.1-52b-smoke", "deepseek-v3-671b-smoke"]


def xlstm_args(device="cpu"):
    return ["--arch", XLSTM, "--device", device, "--devices", "4",
            "--steps", str(STEPS), "--batch", "4", "--seq", "8", "--lr",
            "3e-4", "--seed", "0"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops, which a thread pool per worker only slows when the
    suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def smoke(monkeypatch):
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "GRAD_SEQ", 24)
    return mod


def test_published_sizes(smoke):
    from repro_torch.models.registry import count_params
    assert count_params(smoke.cut_config(
        "xlstm-1.3b", smoke.XLSTM_TRAIN_CUT)) == 508_500_024
    assert count_params(smoke.cut_config(
        "jamba-v0.1-52b", smoke.JAMBA_GRAD_CUT)) == 3_742_306_304
    assert count_params(smoke.cut_config(
        "deepseek-v3-671b", smoke.DS_GRAD_CUT)) == 3_123_099_648
    args = smoke.XLSTM_TRAIN_ARGS
    assert args[args.index("--seq") + 1] == "512"      # two time chunks


def test_xlstm_phase_counts_every_reduce_hop(smoke, monkeypatch, capsys):
    monkeypatch.setattr(collectives, "decode_add", _counting())
    launches = smoke.phase_train_xlstm(
        torch, tops, tref, CODECS, get_config(XLSTM),
        xlstm_args() + smoke.TRAIN_AUTO)
    out = capsys.readouterr().out
    n = out.count("through the kernels is bit-identical")
    # the smoke plan: every DP bucket fractal + int8
    assert n >= 2 and launches == {"bf16": 0, "int8": STEPS * n * 2}
    assert "xlstm step 1: loss" in out and "xent" in out


def test_xlstm_phase_rejects_a_bucket_left_uncounted(smoke, monkeypatch):
    from repro_torch.launch import train as train_cli
    args = train_cli.parse_args(xlstm_args() + smoke.TRAIN_AUTO)
    eng = train_cli.run(get_config(XLSTM),
                        type(args)(**{**vars(args), "steps": 1}))["engine"]
    last = eng.buckets[-1]
    monkeypatch.setattr(collectives, "decode_add",
                        _counting((last.length // 2, last.length // 4)))
    with pytest.raises(AssertionError, match="launches"):
        smoke.phase_train_xlstm(torch, tops, tref, CODECS,
                                get_config(XLSTM),
                                xlstm_args() + smoke.TRAIN_AUTO)


def test_xlstm_phase_adds_an_int8_step_without_a_codec(smoke, monkeypatch,
                                                        capsys):
    monkeypatch.setattr(collectives, "decode_add", _counting())
    launches = smoke.phase_train_xlstm(
        torch, tops, tref, CODECS, get_config(XLSTM),
        xlstm_args() + ["--bucket-codec", "none"])
    out = capsys.readouterr().out
    assert "fixed --bucket-codec int8 step" in out
    n = out.count("through the kernels is bit-identical")
    assert n >= 1 and launches == {"bf16": 0, "int8": n * 2}


def _bf16(name):
    return dataclasses.replace(get_config(name), param_dtype="bfloat16")


@pytest.mark.parametrize("name", GRAD_ARCHS)
def test_grad_phase_passes_a_sound_pair(smoke, capsys, name):
    cos, rel = smoke.phase_grads(torch, _bf16(name), CPU, SMOKE_BOUNDS,
                                 name)
    out = capsys.readouterr().out
    assert "experts with no token" in out and "worst cos" in out
    assert cos >= SMOKE_BOUNDS["cos"] and rel <= SMOKE_BOUNDS["rel"]
    if "deepseek" in name:
        assert f"{name} mtp:" in out


def _passes(smoke, name, seq=24):
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import transformer as T
    cfg = _bf16(name)
    batch = {k: torch.as_tensor(v) for k, v in SyntheticLM(
        cfg, DataConfig(global_batch=2, seq_len=seq, seed=0)).batch(
        0).items()}
    params = T.init_params(cfg, 0, device="cpu")
    lo = smoke._grad_pass(torch, cfg, params, batch)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    hi = smoke._grad_pass(torch, cfg32,
                          _map_tensors(params, lambda t: t.float()), batch)
    return lo, hi


def test_grad_compare_rejects_a_zeroed_leaf(smoke):
    lo, hi = _passes(smoke, GRAD_ARCHS[0])
    smoke.compare_grads(torch, lo, hi, SMOKE_BOUNDS, "sound")
    grads = list(lo[2])
    i = next(i for i, (n, _) in enumerate(grads) if "in_proj" in n)
    grads[i] = (grads[i][0], torch.zeros_like(grads[i][1]))
    with pytest.raises(AssertionError, match="in_proj"):
        smoke.compare_grads(torch, (lo[0], lo[1], grads, lo[3]), hi,
                            SMOKE_BOUNDS, "zeroed")


def test_loss_terms_check(smoke):
    cfg = get_config(GRAD_ARCHS[1])
    m = {"xent": 6.5, "aux": 4.0, "mtp": 6.6}
    loss = 6.5 + cfg.mtp_loss_weight * 6.6 + 0.01 * 4.0
    smoke.check_loss_terms(cfg, loss, m, "sum")
    with pytest.raises(AssertionError, match="sum of its terms"):
        smoke.check_loss_terms(cfg, loss + 1e-4, m, "off")
    with pytest.raises(AssertionError):
        smoke.check_loss_terms(cfg, loss, dict(m, mtp=float("nan")), "nan")


def _without_expert(real, e=3):
    """The router with expert ``e``'s score masked out of the top-k: no
    token picks it (the gradients still flow through every score)."""
    def gates(p, mo, x2d):
        _, _, scores = real(p, mo, x2d)
        col = torch.arange(scores.shape[-1]) == e
        g, idx = torch.topk(scores.masked_fill(col, -1.0), mo.top_k, dim=-1)
        if mo.norm_topk:
            g = g / torch.clamp(g.sum(-1, keepdim=True), min=1e-9)
        return g, idx, scores
    return gates


def test_empty_experts_need_zero_gradients(smoke, monkeypatch):
    """An expert no token picks gets all-zero weight gradients and is
    counted; a model that gives it a gradient anyway is rejected."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config(GRAD_ARCHS[0]),
                              layer_pattern=("mamba", "mamba_moe"),
                              num_layers=2)
    params = T.init_params(cfg, 0, device="cpu")
    monkeypatch.setattr(L, "_router_gates", _without_expert(L._router_gates))
    batch = {k: torch.as_tensor(v) for k, v in SyntheticLM(
        cfg, DataConfig(global_batch=2, seq_len=16, seed=0)).batch(
        0).items()}
    *_, empty = smoke._grad_pass(torch, cfg, params, batch)
    assert empty >= 1
    real = L.apply_moe

    def leaky(p, cfg, x):
        y, aux = real(p, cfg, x)
        return y + 1e-3 * p["w_gate"][3].sum(), aux

    monkeypatch.setattr(L, "apply_moe", leaky)
    with pytest.raises(AssertionError, match="no token"):
        smoke._grad_pass(torch, cfg, params, batch)


@pytest.mark.cuda
@pytest.mark.parametrize("phase", ["5f", "5g", "5h"])
def test_phases_on_the_card(smoke, phase):
    """The three phases at smoke size on the card: B2 counted by its
    wrapper on the xlstm path, and the bf16/f32 pairs within
    ``SMOKE_BOUNDS``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card via chip_smoke / "
                    "pytest -m cuda)")
    dev = torch.device("cuda", 0)
    if phase == "5f":
        launches = smoke.phase_train_xlstm(
            torch, tops, tref, CODECS, get_config(XLSTM),
            xlstm_args("cuda") + smoke.TRAIN_AUTO)
        assert launches["int8"] > 0
    else:
        smoke.phase_grads(torch, _bf16(GRAD_ARCHS[phase == "5h"]), dev,
                          SMOKE_BOUNDS, phase)
