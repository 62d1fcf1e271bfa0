"""Port parity: the codec decode-add op (B1 bf16, B2 int8) against the
reference.

The port's ``decode_add`` on CPU tensors (its plain version, ``ref.py``)
is held to the reference's jitted ``decode_add`` and to its Pallas kernels
in interpret mode, on the same numpy inputs, with ``==``: both are one
rounding per element (bf16 widens exactly and adds once; int8 is one fused
multiply-add, as XLA contracts the dequant-add under ``jit``).  A separate
product and sum rounds twice and is shown to differ.

Keep values include ±0 and ±Inf.  Subnormals are held to IEEE arithmetic
instead: XLA's CPU backend flushes subnormal inputs and results to zero
(``1e-42 + 1e-40`` is 0 there, jitted or not), while the port keeps them,
on the CPU and in the CUDA kernels (built without fast-math), so a
subnormal keep value is a platform difference of the reference, not a
fault of either side.  The CUDA kernels run only on the card: their tests
are marked ``cuda`` and skip without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.tree_reduce import ops as jax_ops
from repro.optim.compression import Bf16Codec as JBf16, Int8Codec as JInt8
from repro_torch.kernels.tree_reduce import ops
from repro_torch.optim.compression import Bf16Codec, Int8Codec

SPECIAL = np.array([0.0, -0.0, np.inf, -np.inf], np.float32)
SUBNORMAL = np.array([1e-42, -3e-39], np.float32)


def _keep(rng, M, special=SPECIAL):
    keep = rng.standard_normal(M).astype(np.float32)
    keep[:min(M, len(special))] = special[:M]
    return keep


def _payload(rng, M):
    """Gradient-like values over many magnitudes (per-block scales
    differ)."""
    x = rng.standard_normal(M) * np.exp(2 * rng.standard_normal(M))
    return x.astype(np.float32)


def _bits(a):
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("M", [1, 127, 128, 513, 4096, 5000])
def test_bf16_matches_reference(M):
    rng = np.random.default_rng(M)
    keep, x = _keep(rng, M), _payload(rng, M)
    jwire = JBf16().encode(jnp.asarray(x))
    want = np.asarray(jax.jit(lambda k, w: jax_ops.decode_add(
        k, w, JBf16()))(jnp.asarray(keep), jwire))
    wire = Bf16Codec().encode(torch.from_numpy(x))
    got = ops.decode_add(torch.from_numpy(keep), wire, Bf16Codec()).numpy()
    assert np.array_equal(_bits(got), _bits(want))
    # the Pallas kernel (interpret mode) where it takes the shape
    block = min(512, 1 << max(1, (M - 1).bit_length()))
    if M % block == 0:
        kern = np.asarray(jax_ops.decode_add(jnp.asarray(keep), jwire,
                                             JBf16(), interpret=True))
        assert np.array_equal(_bits(got), _bits(kern))


@pytest.mark.parametrize("nb", [1, 3, 8, 37])
def test_int8_matches_reference_fma(nb):
    M = nb * 128
    rng = np.random.default_rng(100 + nb)
    keep, x = _keep(rng, M), _payload(rng, M)
    jwire = jax.jit(JInt8().encode)(jnp.asarray(x))
    want = np.asarray(jax.jit(lambda k, w: jax_ops.decode_add(
        k, w, JInt8()))(jnp.asarray(keep), jwire))
    kern = np.asarray(jax_ops.decode_add(jnp.asarray(keep), jwire, JInt8(),
                                         interpret=True))
    wire = Int8Codec().encode(torch.from_numpy(x))
    assert np.array_equal(wire["q"].numpy(), np.asarray(jwire["q"]))
    assert np.array_equal(wire["scale"].numpy(), np.asarray(jwire["scale"]))
    got = ops.decode_add(torch.from_numpy(keep), wire, Int8Codec()).numpy()
    assert np.array_equal(_bits(got), _bits(want))
    assert np.array_equal(_bits(got), _bits(kern))


def test_int8_separate_rounding_would_fail():
    """``keep + f32(q) * scale`` (two roundings) is not the reference."""
    M = 512 * 128
    rng = np.random.default_rng(7)
    keep, x = _keep(rng, M), _payload(rng, M)
    jwire = jax.jit(JInt8().encode)(jnp.asarray(x))
    want = np.asarray(jax.jit(lambda k, w: jax_ops.decode_add(
        k, w, JInt8()))(jnp.asarray(keep), jwire))
    wire = Int8Codec().encode(torch.from_numpy(x))
    tk = torch.from_numpy(keep).view(-1, 128)
    two = (tk + wire["q"].float() * wire["scale"]).reshape(-1).numpy()
    differ = np.mean(_bits(two) != _bits(want))
    assert differ > 0.05, differ
    got = ops.decode_add(torch.from_numpy(keep), wire, Int8Codec()).numpy()
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_subnormal_keep_values_follow_ieee(codec):
    """keep + decode(wire) with subnormal keeps, against the exact sum
    rounded once (f64 holds every product and sum here exactly)."""
    rng = np.random.default_rng(11)
    M = 256
    keep = _keep(rng, M, np.concatenate([SUBNORMAL, SPECIAL]))
    x = _payload(rng, M)
    x[:4] = [0.0, 0.0, 1e-40, 0.0]            # exact zero / tiny decodes
    c = Bf16Codec() if codec == "bf16" else Int8Codec()
    wire = c.encode(torch.from_numpy(x))
    dec = c.decode(wire, (M,), torch.float32).double().numpy()
    got = ops.decode_add(torch.from_numpy(keep), wire, c).numpy()
    want = (keep.astype(np.float64) + dec).astype(np.float32)
    assert np.array_equal(_bits(got[:4]), _bits(want[:4]))
    assert got[0] == SUBNORMAL[0] and got[1] == SUBNORMAL[1]


def test_decode_add_rejects_other_codecs():
    keep = torch.zeros(128)
    with pytest.raises(ValueError, match="no kernel"):
        ops.decode_add(keep, {"x": keep}, None)


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises: no CPU fallback."""
    keep = torch.zeros(128)
    with pytest.raises(ValueError, match="CUDA"):
        ops.decode_add_bf16_kernel(keep, keep.to(torch.bfloat16))
    with pytest.raises(ValueError, match="CUDA"):
        ops.decode_add_int8_kernel(keep, torch.zeros(128, dtype=torch.int8),
                                   torch.zeros(1))


@pytest.mark.cuda
@pytest.mark.parametrize("codec,M", [("bf16", 1), ("bf16", 127),
                                     ("bf16", 513), ("bf16", (1 << 20) + 17),
                                     ("int8", 128), ("int8", 3 * 128),
                                     ("int8", 8192 * 128)])
def test_cuda_kernels_match_ref_bit_for_bit(codec, M):
    """On the card: the kernel launches (its count moves) and equals ref.py
    bit for bit, on both the vectorised and the unaligned path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card via chip_smoke / "
                    "pytest -m cuda)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(M)
    keep = torch.from_numpy(_keep(
        rng, M + 1, np.concatenate([SPECIAL, SUBNORMAL]))).to(dev)
    x = torch.from_numpy(_payload(rng, M + 1)).to(dev)
    for off in (0, 1):                      # 1: pointers off 16 B alignment
        k, xs = keep[off:off + M], x[off:off + M]
        c = Bf16Codec() if codec == "bf16" else Int8Codec()
        wire = c.encode(xs)
        before = (ops.BF16_LAUNCHES, ops.INT8_LAUNCHES)
        got = ops.decode_add(k, wire, c)
        torch.cuda.synchronize()
        after = (ops.BF16_LAUNCHES, ops.INT8_LAUNCHES)
        assert sum(after) == sum(before) + 1
        want = ops.decode_add(k.cpu(), {n: v.cpu() for n, v in wire.items()},
                              c)
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32))
