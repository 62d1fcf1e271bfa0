"""Port parity: the public ``flash_attention`` op (B5 forward, backward by
recompute) against the reference.

The reference's op runs as ``tests/test_kernels.py`` runs it (its Pallas
kernel in interpret mode); the port's on CPU tensors runs its plain
version.  Same numpy inputs, at that file's tolerances: 2e-4 (rtol and
atol) in f32, 2e-2 in bf16.

  * forward on ``tests/test_kernels.py``'s ``ATTN_CASES`` (causal, GQA,
    MQA with a window, softcap, unaligned T, bidirectional): against the
    reference's op;
  * forward in the three padding cases where the reference's op lets its
    zero-padded keys into the softmax (non-causal 130/130 and 64/200,
    causal Tq 256 > Tk 130; ROADMAP C2): against the reference's
    ``flash_attention_ref``, which the port is held to everywhere.  The
    test also shows the reference's op off by more than 1e-2 there;
  * a window that leaves rows seeing no key (i >= Tk + window - 1): those
    rows are left out of the comparison; on the CPU the port returns the
    plain version's mean of V there, as the reference's ref does (the
    kernel returns 0);
  * gradients of q, k and v against ``jax.grad`` of the reference's op,
    within 1e-3 (both recompute through their plain versions).

The CUDA kernel runs only on the card: its test is marked ``cuda`` and
skips here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import (flash_attention_ref as
                                               jax_flash_ref)
from repro_torch.kernels.flash_attention import ops, ref

ATTN_CASES = [
    # (B, Tq, Tk, Hq, Hkv, D, causal, window, softcap)
    (2, 128, 128, 4, 4, 64, True, None, None),
    (1, 256, 256, 8, 2, 64, True, None, None),        # GQA
    (1, 256, 256, 4, 1, 128, True, 64, None),         # MQA + window
    (1, 128, 128, 2, 2, 64, True, None, 50.0),        # softcap
    (2, 200, 200, 4, 2, 32, True, None, None),        # unaligned T
    (1, 128, 128, 4, 4, 64, False, None, None),       # bidirectional
]
PADDING_CASES = [
    # (B, Tq, Tk, Hq, Hkv, D, causal)
    (1, 130, 130, 2, 2, 64, False),
    (1, 64, 200, 2, 1, 64, False),
    (1, 256, 130, 2, 1, 64, True),
]
TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _inputs(B, Tq, Tk, Hq, Hkv, D, seed, Dv=None):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Tq, Hq, D)).astype(np.float32),
            rng.standard_normal((B, Tk, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, Tk, Hkv, Dv or D)).astype(np.float32))


def _jax_ref_heads(q, k, v, **kw):
    """The reference's ``flash_attention_ref`` on [B, T, H, D] inputs (its
    op's own head flattening: head h reads KV head h // G)."""
    B, Tq, Hq, D = q.shape
    Tk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = Hq // Hkv
    qf = q.transpose(0, 2, 1, 3).reshape(B * Hq, Tq, D)
    kf = jnp.repeat(k.transpose(0, 2, 1, 3), G, axis=1).reshape(-1, Tk, D)
    vf = jnp.repeat(v.transpose(0, 2, 1, 3), G, axis=1).reshape(-1, Tk, Dv)
    out = jax_flash_ref(qf, kf, vf, **kw)
    return out.reshape(B, Hq, Tq, Dv).transpose(0, 2, 1, 3)


def _both(arrays, dtype):
    return ([jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays])


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference_op(case, dtype):
    B, Tq, Tk, Hq, Hkv, D, causal, window, cap = case
    (jq, jk, jv), (q, k, v) = _both(_inputs(B, Tq, Tk, Hq, Hkv, D, Tq + Hq),
                                    dtype)
    want = jax_flash(jq, jk, jv, causal=causal, window=window, softcap=cap)
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=cap)
    assert got.dtype == q.dtype and tuple(got.shape) == (B, Tq, Hq, D)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("case", PADDING_CASES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padding_cases_match_reference_ref(case, dtype):
    B, Tq, Tk, Hq, Hkv, D, causal = case
    (jq, jk, jv), (q, k, v) = _both(_inputs(B, Tq, Tk, Hq, Hkv, D, Tk),
                                    dtype)
    want = _jax_ref_heads(jq, jk, jv, causal=causal)
    got = ops.flash_attention(q, k, v, causal=causal)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


def test_reference_op_lets_padded_keys_in():
    """Why the padding cases are held to the reference's ref and not its
    op: the op is off by more than 1e-2 in each (ROADMAP C2), the port by
    less than 2e-4."""
    for B, Tq, Tk, Hq, Hkv, D, causal in PADDING_CASES:
        (jq, jk, jv), (q, k, v) = _both(_inputs(B, Tq, Tk, Hq, Hkv, D, Tk),
                                        "float32")
        want = np.asarray(_jax_ref_heads(jq, jk, jv, causal=causal))
        op = np.asarray(jax_flash(jq, jk, jv, causal=causal))
        got = ops.flash_attention(q, k, v, causal=causal).numpy()
        assert np.abs(op - want).max() > 1e-2
        assert np.abs(got - want).max() < 2e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rows_without_keys_are_left_out(dtype):
    """Causal with a window of 32 over Tk = 64 keys: rows 95.. see none.
    The others match the reference's ref; on the CPU those rows are the
    mean of V, as in the reference's ref."""
    B, Tq, Tk, Hq, Hkv, D, window = 1, 192, 64, 4, 2, 32, 32
    (jq, jk, jv), (q, k, v) = _both(_inputs(B, Tq, Tk, Hq, Hkv, D, 3),
                                    dtype)
    want = np.asarray(_jax_ref_heads(jq, jk, jv, causal=True,
                                     window=window), np.float32)
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    seen = ref.attention_mask(Tq, Tk, causal=True, window=window).any(-1)
    assert int((~seen).sum()) == Tq - (Tk + window - 1)
    np.testing.assert_allclose(got[:, seen].float().numpy(),
                               want[:, seen.numpy()], **TOL[dtype])
    mean_v = v.float().mean(1).repeat_interleave(Hq // Hkv, dim=1)
    np.testing.assert_allclose(got[0, ~seen].float().numpy(),
                               mean_v.expand(int((~seen).sum()), -1,
                                             -1).numpy(), **TOL[dtype])


def test_d_and_dv_may_differ():
    """MLA prefill shapes: D = 24, Dv = 16 (cut from 192 / 128)."""
    arrays = _inputs(1, 64, 64, 4, 4, 24, 11, Dv=16)
    (jq, jk, jv), (q, k, v) = _both(arrays, "float32")
    want = jax_flash(jq, jk, jv)
    got = ops.flash_attention(q, k, v)
    assert tuple(got.shape) == (1, 64, 4, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])


@pytest.mark.parametrize("case", [
    (1, 128, 128, 2, 2, 32, True, None, None),
    (1, 128, 128, 4, 2, 32, True, 48, 20.0)], ids=str)
def test_grads_match_jax_grad(case):
    B, Tq, Tk, Hq, Hkv, D, causal, window, cap = case
    arrays = _inputs(B, Tq, Tk, Hq, Hkv, D, 17)
    kw = dict(causal=causal, window=window, softcap=cap)

    def loss(q, k, v):
        return jnp.sum(jax_flash(q, k, v, **kw) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, arrays))
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = ops.flash_attention(*leaves, **kw)
    got = torch.autograd.grad(out.pow(2).sum(), leaves)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3,
                                   atol=1e-3)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches its kernel or raises: no CPU fallback."""
    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention_kernel(q, q, q)


@pytest.mark.parametrize("name,off", [("q", 1), ("k", 4), ("v", 7)])
def test_bf16_kernel_needs_16_byte_aligned_tensors(name, off):
    """The bf16 kernel reads q, k and v by TMA: the wrapper raises on a
    tensor that starts off 16 bytes and launches nothing (no other
    kernel takes over)."""
    shape = (1, 4, 2, 16)
    ts = {n: torch.zeros(shape, dtype=torch.bfloat16) for n in "qkv"}
    ts[name] = torch.zeros(128 + off, dtype=torch.bfloat16)[off:].view(shape)
    assert ts[name].is_contiguous() and ts[name].data_ptr() % 16
    with pytest.raises(ValueError, match=f"{name} starts at .* not on 16"):
        ops.check_aligned(ts["q"], ts["k"], ts["v"])
    ops.check_aligned(*(torch.zeros(shape, dtype=torch.bfloat16)
                        for _ in "qkv"))


def test_shapes_are_checked():
    q = torch.zeros(1, 4, 3, 16)
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(q, torch.zeros(1, 4, 2, 16),
                            torch.zeros(1, 4, 2, 16))


# the wgmma kernel's tile edges: Tq and Tk one past 128 and one past its
# key tile (128 at D <= 128, 64 at D 256), Hq / Hkv = 1, 2 and 8
EDGE_CASES = [
    (1, 129, 129, 1, 1, 128, True, None, None),
    (1, 129, 65, 8, 1, 256, True, None, 50.0),
    (2, 129, 129, 4, 2, 64, False, None, None),
    (1, 65, 65, 2, 1, 256, True, 32, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ATTN_CASES + EDGE_CASES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_ref(case, dtype):
    """On the card: one launch per call, within the tolerances above of
    the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card via chip_smoke / "
                    "pytest -m cuda)")
    B, Tq, Tk, Hq, Hkv, D, causal, window, cap = case
    q, k, v = (torch.from_numpy(a).to(getattr(torch, dtype)).cuda() for a in
               _inputs(B, Tq, Tk, Hq, Hkv, D, Tq + Hq))
    kw = dict(causal=causal, window=window, softcap=cap)
    path = "wgmma" if dtype == "bfloat16" else "f32"
    before, by_path = ops.LAUNCHES, ops.PATH_LAUNCHES[path]
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    assert ops.PATH_LAUNCHES[path] == by_path + 1
    want = ops.flash_attention_heads_ref(q, k, v, **kw)
    seen = ref.attention_mask(Tq, Tk, causal=causal, window=window,
                              device=q.device).any(-1)
    np.testing.assert_allclose(got[:, seen].float().cpu().numpy(),
                               want[:, seen].float().cpu().numpy(),
                               **TOL[dtype])


# ---------------------------------------------------------------------------
# the CUDA path of the public op (ROADMAP C5): pad-and-slice and copies
# around a strict kernel, checked here with a stand-in for it
# ---------------------------------------------------------------------------


class _StrictKernel:
    """Takes only what ``flash_attention_kernel`` takes (contiguous, on 16
    bytes, bf16 D and Dv in multiples of 16, at most 256) and computes the
    plain version's arithmetic at the ``scale`` it is given; records the
    (D, Dv, scale) of each call."""

    def __init__(self):
        self.calls = []

    def __call__(self, q, k, v, *, causal, window, softcap, scale):
        for t in (q, k, v):
            assert t.is_contiguous() and t.data_ptr() % 16 == 0
        D, Dv = q.shape[3], v.shape[3]
        assert max(D, Dv) <= ops.MAX_HEAD_DIM
        if q.dtype == torch.bfloat16:
            assert D % 16 == 0 and Dv % 16 == 0
        self.calls.append((D, Dv, scale))
        B, Tq, Hq, _ = q.shape
        Tk, Hkv = k.shape[1], k.shape[2]
        kf = k.repeat_interleave(Hq // Hkv, dim=2)
        vf = v.repeat_interleave(Hq // Hkv, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", q, kf).float() * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        mask = ref.attention_mask(Tq, Tk, causal=causal, window=window)
        p = torch.softmax(torch.where(mask, s, ref.NEG_INF), -1)
        o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), vf)
        return o.to(q.dtype).contiguous()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_forward_pads_d_72_dv_40_and_keeps_the_scale(dtype):
    """D 72 / Dv 40: bf16 goes to the kernel as 80 / 48 (zero columns),
    f32 as it is; the scale stays 1/sqrt(72); the output, sliced back to
    Dv 40, matches the reference's ``flash_attention_ref``."""
    arrays = _inputs(2, 96, 96, 4, 2, 72, 21, Dv=40)
    (jq, jk, jv), (q, k, v) = _both(arrays, dtype)
    kernel = _StrictKernel()
    got = ops.kernel_forward(kernel, q, k, v, causal=True, softcap=50.0)
    want = _jax_ref_heads(jq, jk, jv, causal=True, softcap=50.0)
    padded = (80, 48) if dtype == "bfloat16" else (72, 40)
    assert kernel.calls == [padded + (1.0 / np.sqrt(72),)]
    assert tuple(got.shape) == (2, 96, 4, 40) and got.is_contiguous()
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("name", ["q", "k", "v"])
def test_kernel_forward_copies_a_view_off_16_bytes(name):
    """A bf16 input that starts 2 bytes off 16 (contiguous, so
    ``.contiguous()`` would hand it over as it is) reaches the kernel as an
    aligned copy; the output matches the reference's ref."""
    arrays = _inputs(1, 64, 64, 4, 2, 32, 22)
    (jq, jk, jv), ts = _both(arrays, "bfloat16")
    i = "qkv".index(name)
    buf = torch.empty(ts[i].numel() + 1, dtype=torch.bfloat16)
    ts[i] = buf[1:].view(ts[i].shape).copy_(ts[i])
    assert ts[i].is_contiguous() and ts[i].data_ptr() % 16
    kernel = _StrictKernel()
    got = ops.kernel_forward(kernel, *ts, causal=True)
    want = _jax_ref_heads(jq, jk, jv, causal=True)
    assert kernel.calls == [(32, 32, 1.0 / np.sqrt(32))]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **TOL["bfloat16"])


@pytest.mark.parametrize("D,Dv", [(264, 64), (64, 320)])
def test_kernel_forward_states_the_cards_head_dim_limit(D, Dv):
    q = torch.zeros(1, 8, 2, D)
    v = torch.zeros(1, 8, 2, Dv)
    kernel = _StrictKernel()
    with pytest.raises(ValueError, match="card's kernels take D and Dv up "
                                         "to 256"):
        ops.kernel_forward(kernel, q, q, v)
    assert kernel.calls == []
