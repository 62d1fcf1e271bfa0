"""Port parity: the public tree-sum ops (B3 ``tree_reduce``, B4 through
``coded_tree_reduce``) and ``encode_rows`` against the reference.

The reference runs as ``tests/test_kernels.py`` runs it: its ops reach the
Pallas kernels in interpret mode.  The port's ops on CPU tensors run their
plain versions (``ref.py``).  Inputs are numpy, from a seed.

  * ``tree_reduce`` (f32 and bf16, N = 1, 2, 3, 8, 13, 16, 32, ragged D,
    ±0 and ±Inf columns) and ``coded_tree_reduce`` with the ``none`` and
    ``bf16`` codecs: ``==``, bit for bit, with one exception in the sign of
    zero.  N = 1 pads to 2 with a zero row in both, so -0 + 0 comes back
    +0, and the port always returns that.  The reference does too when its
    grid has several column blocks (D > 512), but with one block and f32
    rows XLA folds the add of the all-zero pad row away (``x + 0`` to
    ``x``) and -0 stays -0.  There the comparison is ``==`` by value (±0
    equal) and bit for bit everywhere else.
  * ``encode_rows`` codes and scales: ``==`` (the reference runs it
    eagerly: true divisions, round half to even).
  * ``coded_tree_reduce`` with ``int8``: the port fuses the low row's
    dequant into the first add, ``fma(q[i], s[i], q[i + N/2] * s[i + N/2])``,
    which is what the reference's interpret-mode kernel computes when the
    rows pad to 2, 4, 8 or 32: ``==`` there.  Padded to 16 rows, XLA rounds
    that product separately (the test shows the reference equal bit for bit
    to that two-rounding order); the port then differs by one rounding of
    each low-row product, carried through the later adds: at most 2^-20 of
    the column's absolute sum (9 half-ulps of it bound one product
    rounding plus four re-roundings; where the rows cancel, that can be
    tens of ulps of the result).  The reference's own test allows "an
    ulp" for the same reason (``tests/test_kernels.py``, coded parity).

Subnormal inputs are left out of the reference comparisons: XLA's CPU
backend flushes them to zero (ROADMAP C3), while the port keeps IEEE
arithmetic; the card's kernels are held to the plain versions with
subnormals in ``chip_smoke.py``.  The CUDA kernels run only on the card:
their tests are marked ``cuda`` and skip here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.tree_reduce import ops as jops
from repro.kernels.tree_reduce import ref as jref
from repro_torch.kernels.tree_reduce import ops, ref

NS = [1, 2, 3, 8, 13, 16, 32]


def _rows(rng, n, d):
    x = rng.standard_normal((n, d)) * np.exp(2 * rng.standard_normal((n, d)))
    x = x.astype(np.float32)
    if d >= 4:
        x[:, 0], x[:, 1] = 0.0, -0.0
        x[0, 2], x[-1, 3] = np.inf, -np.inf
    return x


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _jax(x, dtype):
    return jnp.asarray(x).astype(dtype)


def _torch(x, dtype):
    return torch.from_numpy(np.array(x)).to(dtype)


def _np(t):
    """A torch tensor as numpy bits-preserving (bf16 as its uint16 bits)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _jnp_bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a.view(np.uint32)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("d", [5, 700])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_reduce_matches_reference(n, d, dtype):
    x = _rows(np.random.default_rng(n * 1000 + d), n, d)
    want = jops.tree_reduce(_jax(x, getattr(jnp, dtype)))
    got = ops.tree_reduce(_torch(x, getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (d,)
    _assert_equal_but_folded_zeros(_np(got), want, n)


def _assert_equal_but_folded_zeros(got, want, n):
    """Bit for bit, except that at N = 1 a zero may differ in sign only
    (the reference's folded pad-row add; see the module docstring)."""
    got_bits, want_bits = _bits(got), _jnp_bits(want)
    if n == 1:
        want_f = np.asarray(want).astype(np.float32)
        zeros = want_f == 0
        got_f = np.asarray(got).astype(np.float32) if got.dtype != \
            np.uint16 else (got.astype(np.uint32) << 16).view(np.float32)
        assert np.array_equal(got_f[zeros], want_f[zeros])      # ±0 equal
        assert not np.signbit(got_f[zeros]).any()               # -0 + 0
        got_bits, want_bits = got_bits[~zeros], want_bits[~zeros]
    assert np.array_equal(got_bits, want_bits)


@pytest.mark.parametrize("d", [3, 700])
def test_tree_reduce_of_one_row_pads_with_a_zero_row(d):
    """-0 + 0 = +0: the reference's op with several column blocks and the
    port agree bit for bit; with one block (D <= 512) the reference keeps
    the -0 of its input, the fold of its pad-row add."""
    x = np.zeros((1, d), np.float32)
    x[0, :3] = [-0.0, 1.0, -2.5]
    got = ops.tree_reduce(torch.from_numpy(x)).numpy()
    want = np.asarray(jops.tree_reduce(jnp.asarray(x)))
    assert not np.signbit(got[0]) and np.array_equal(got, want)
    assert np.signbit(want[0]) == (d <= 512)
    assert np.array_equal(got.view(np.uint32)[1:], want.view(np.uint32)[1:])


def test_tree_order_is_not_linear_order():
    """The tree sum is its own order: equal to the reference's tree oracle
    bit for bit, and not to a left-to-right sum of the same rows."""
    x = np.random.default_rng(3).standard_normal((16, 512)) * 1e3
    x = x.astype(np.float32)
    got = ops.tree_reduce(torch.from_numpy(x)).numpy()
    assert np.array_equal(got.view(np.uint32),
                          np.asarray(jref.tree_reduce_ref(
                              jnp.asarray(x))).view(np.uint32))
    lin = ref.linear_reduce_ref(torch.from_numpy(x)).numpy()
    assert np.array_equal(lin.view(np.uint32), np.asarray(
        jref.linear_reduce_ref(jnp.asarray(x))).view(np.uint32))
    assert not np.array_equal(got, lin)


@pytest.mark.parametrize("n", [3, 6, 12])
def test_tree_reduce_ref_refuses_a_ragged_stack(n):
    """The reference's oracle drops rows when N is not a power of two; the
    port's raises instead (the ops pad first)."""
    with pytest.raises(ValueError, match="power of two"):
        ref.tree_reduce_ref(torch.zeros(n, 4))
    with pytest.raises(ValueError, match="power of two"):
        ref.int8_tree_reduce_ref(torch.zeros(n, 1, 128, dtype=torch.int8),
                                 torch.zeros(n, 1, 1))


@pytest.mark.parametrize("n,d", [(2, 128), (6, 384), (5, 1280)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_rows_matches_reference(n, d, dtype):
    x = _rows(np.random.default_rng(n + d), n, d)
    x[:, :4] = np.random.default_rng(1).standard_normal((n, 4))
    x[0, :128] = 0.0                                   # an all-zero block
    for codec in ("none", "bf16", "int8"):
        want = jops.encode_rows(_jax(x, getattr(jnp, dtype)), codec)
        got = ops.encode_rows(_torch(x, getattr(torch, dtype)), codec)
        assert sorted(got) == sorted(want)
        for key in got:
            assert tuple(got[key].shape) == tuple(want[key].shape)
            assert np.array_equal(_bits(_np(got[key])),
                                  _jnp_bits(want[key])) if \
                got[key].dtype != torch.int8 else np.array_equal(
                    got[key].numpy(), np.asarray(want[key]))


@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
def test_decode_rows_matches_reference(codec):
    x = _rows(np.random.default_rng(4), 6, 384)
    x[:, :4] = 1.5
    want = jops._decode_rows(jops.encode_rows(jnp.asarray(x), codec), codec,
                             jnp.float32)
    got = ops._decode_rows(ops.encode_rows(torch.from_numpy(x), codec),
                           codec, torch.float32)
    assert np.array_equal(got.numpy().view(np.uint32),
                          np.asarray(want).view(np.uint32))


def test_encode_rows_refuses_ragged_int8():
    with pytest.raises(ValueError, match="not divisible"):
        ops.encode_rows(torch.zeros(2, 130), "int8")
    with pytest.raises(ValueError, match="unknown codec"):
        ops.encode_rows(torch.zeros(2, 128), "fp8")


@pytest.mark.parametrize("codec", ["none", "bf16"])
@pytest.mark.parametrize("n,d", [(1, 128), (2, 128), (6, 384), (13, 700),
                                 (16, 512)])
def test_coded_tree_reduce_matches_reference(codec, n, d):
    x = _rows(np.random.default_rng(7 * n + d), n, d)
    want = jops.coded_tree_reduce(jops.encode_rows(jnp.asarray(x), codec),
                                  codec)
    got = ops.coded_tree_reduce(ops.encode_rows(torch.from_numpy(x), codec),
                                codec)
    assert got.dtype == torch.float32 and tuple(got.shape) == (d,)
    _assert_equal_but_folded_zeros(got.numpy(), want, n)


def _int8_case(n, nb, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, nb * 128)) * np.exp(
        2 * rng.standard_normal((n, nb * 128)))
    x = x.astype(np.float32)
    jwire = jops.encode_rows(jnp.asarray(x), "int8")
    want = np.asarray(jops.coded_tree_reduce(jwire, "int8"))
    wire = ops.encode_rows(torch.from_numpy(x), "int8")
    got = ops.coded_tree_reduce(wire, "int8")
    assert got.dtype == torch.float32 and tuple(got.shape) == (nb * 128,)
    return wire, got.numpy(), want


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 17, 32])
@pytest.mark.parametrize("nb", [1, 37])
def test_coded_int8_matches_reference_fused(n, nb):
    """Rows padding to 2, 4, 8 or 32: the reference fuses the low row's
    dequant into the first add, as the port does."""
    _, got, want = _int8_case(n, nb, 100 * n + nb)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("n", [9, 13, 16])
@pytest.mark.parametrize("nb", [37])
def test_coded_int8_at_sixteen_rows_differs_by_one_product_rounding(n, nb):
    """Rows padding to 16: the reference rounds each dequant product
    separately (shown bit for bit); the port is within one rounding of
    each product, carried through the later adds."""
    wire, got, want = _int8_case(n, nb, 100 * n + nb)
    q, s = ref.pad_rows(wire["q"]).float(), ref.pad_rows(wire["scale"])
    prods = (q * s).reshape(16, -1)
    two_roundings = ref._halve(prods).numpy()
    assert np.array_equal(two_roundings.view(np.uint32),
                          want.view(np.uint32))
    bound = 2.0 ** -20 * prods.abs().double().sum(0).numpy()
    assert np.all(np.abs(got.astype(np.float64) - want) <= bound)


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises: no CPU fallback."""
    with pytest.raises(ValueError, match="CUDA"):
        ops.tree_reduce_kernel(torch.zeros(4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        ops.int8_tree_reduce_kernel(torch.zeros(2, 1, 128, dtype=torch.int8),
                                    torch.zeros(2, 1, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 13, 16, 32])
@pytest.mark.parametrize("d", [1, 700, 4097])
def test_cuda_tree_kernels_match_ref_bit_for_bit(n, d):
    """On the card: each op launches its kernel once (its count moves) and
    equals the plain version bit for bit, f32/bf16 rows into f32/bf16, and
    int8 rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card via chip_smoke / "
                    "pytest -m cuda)")
    dev = torch.device("cuda")
    x = torch.from_numpy(_rows(np.random.default_rng(n + d), n, d))
    for dtype in (torch.float32, torch.bfloat16):
        for out_dtype in (torch.float32, torch.bfloat16):
            before = ops.TREE_SUM_LAUNCHES
            got = ops.tree_reduce_kernel(x.to(dtype).to(dev), out_dtype)
            torch.cuda.synchronize()
            assert ops.TREE_SUM_LAUNCHES == before + 1
            want = ref.tree_reduce_ref(ref.pad_rows(x.to(dtype)), out_dtype)
            assert torch.equal(got.cpu().view(torch.int16 if out_dtype ==
                                              torch.bfloat16 else torch.int32),
                               want.view(torch.int16 if out_dtype ==
                                         torch.bfloat16 else torch.int32))
    nb = max(1, d // 128)
    wire = ops.encode_rows(torch.from_numpy(
        _rows(np.random.default_rng(n), n, nb * 128)).nan_to_num(0, 0, 0),
        "int8")
    before = ops.INT8_TREE_SUM_LAUNCHES
    got = ops.coded_tree_reduce({k: v.to(dev) for k, v in wire.items()},
                                "int8")
    torch.cuda.synchronize()
    assert ops.INT8_TREE_SUM_LAUNCHES == before + 1
    want = ops.coded_tree_reduce(wire, "int8")
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
