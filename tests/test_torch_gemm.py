"""Port parity: the public ``gemm`` op (B6) against the reference.

The reference's ``gemm`` runs as ``tests/test_kernels.py`` runs it (its
Pallas kernel in interpret mode, dimensions padded to the block); the
port's on CPU tensors runs its plain version, an f32 matmul rounded once to
x's dtype.  Same numpy inputs, on ``tests/test_kernels.py``'s shapes, at
the tolerances of that file: 2e-4 (rtol and atol) in f32, 2e-2 in bf16
(the two round the same f32 sums, taken in another order, to bf16).  The
CUDA kernel runs only on the card: its test is marked ``cuda`` and skips
here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gemm.ops import gemm as jax_gemm
from repro.kernels.gemm.ref import gemm_ref as jax_gemm_ref
from repro_torch.kernels.gemm import ops, ref

GEMM_SHAPES = [(128, 128, 128), (256, 128, 384), (200, 300, 150),
               (64, 512, 64), (1, 128, 1), (130, 257, 129)]
TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _inputs(m, k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


@pytest.mark.parametrize("m,k,n", GEMM_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_matches_reference(m, k, n, dtype):
    x, y = _inputs(m, k, n, m * k + n)
    want = jax_gemm(jnp.asarray(x).astype(getattr(jnp, dtype)),
                    jnp.asarray(y).astype(getattr(jnp, dtype)))
    got = ops.gemm(torch.from_numpy(x).to(getattr(torch, dtype)),
                   torch.from_numpy(y).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_ref_matches_reference_ref(dtype):
    x, y = _inputs(130, 257, 129, 5)
    want = jax_gemm_ref(jnp.asarray(x).astype(getattr(jnp, dtype)),
                        jnp.asarray(y).astype(getattr(jnp, dtype)))
    got = ref.gemm_ref(torch.from_numpy(x).to(getattr(torch, dtype)),
                       torch.from_numpy(y).to(getattr(torch, dtype)))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


def test_gemm_ref_accumulates_in_f32_and_rounds_once():
    """bf16 inputs: the f32 product of the widened inputs, rounded to bf16
    once, not a bf16 sum."""
    x, y = _inputs(8, 4096, 8, 9)
    xb, yb = torch.from_numpy(x).bfloat16(), torch.from_numpy(y).bfloat16()
    got = ref.gemm_ref(xb, yb)
    want = (xb.double() @ yb.double()).float().bfloat16()
    assert got.dtype == torch.bfloat16
    assert (got.float() - want.float()).abs().max() <= \
        2 ** -8 * want.float().abs().max()
    assert ref.gemm_ref(xb, yb, torch.float32).dtype == torch.float32


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches its kernel or raises: no CPU fallback."""
    with pytest.raises(ValueError, match="CUDA"):
        ops.gemm_kernel(torch.zeros(4, 8), torch.zeros(8, 2))


def _offset(rows, cols, off, dtype=torch.bfloat16):
    """A contiguous [rows, cols] matrix that starts ``off`` elements into
    its buffer (off 16 bytes for any off that is not a multiple of 8)."""
    return torch.zeros(rows * cols + off, dtype=dtype)[off:].view(rows, cols)


@pytest.mark.parametrize("m,k,n,x_off,y_off,dtype,path", [
    (2048, 2304, 9216, 0, 0, torch.bfloat16, "wgmma"),   # the timed shape
    (8, 7168, 2048, 0, 0, torch.bfloat16, "wgmma"),      # decode rows
    (257, 72, 200, 0, 0, torch.bfloat16, "wgmma"),       # tile edges + 8
    (256, 8, 192, 0, 0, torch.bfloat16, "wgmma"),        # K = 8
    (1000, 2300, 776, 0, 0, torch.bfloat16, "mma"),      # K % 8 != 0
    (1000, 2304, 770, 0, 0, torch.bfloat16, "mma"),      # N % 8 != 0
    (257, 72, 200, 1, 0, torch.bfloat16, "mma"),         # x off 16 bytes
    (257, 72, 200, 0, 4, torch.bfloat16, "mma"),         # y off 16 bytes
    (257, 72, 200, 8, 8, torch.bfloat16, "wgmma"),       # 16 bytes in
    (8, 0, 8, 0, 0, torch.bfloat16, "mma"),              # K = 0
    (2048, 2304, 9216, 0, 0, torch.float32, "f32")])
def test_gemm_path_by_dtype_shape_and_pointers(m, k, n, x_off, y_off, dtype,
                                               path):
    """The kernel the wrapper launches, decided before the launch: wgmma
    only where TMA can read x and y (K and N multiples of 8, both on 16
    bytes)."""
    x, y = _offset(m, k, x_off, dtype), _offset(k, n, y_off, dtype)
    assert x.is_contiguous() and y.is_contiguous()
    assert ops.gemm_path(x, y) == path


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", GEMM_SHAPES + [
    (1000, 2300, 770), (8, 7168, 2048), (257, 72, 200), (256, 8, 192),
    (256, 64, 384), (257, 65, 193)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_gemm_matches_ref(m, k, n, dtype):
    """On the card: one launch per call, within the tolerances above of
    the plain version (TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card via chip_smoke / "
                    "pytest -m cuda)")
    torch.backends.cuda.matmul.allow_tf32 = False
    x, y = _inputs(m, k, n, m + k + n)
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).cuda()
    yt = torch.from_numpy(y).to(getattr(torch, dtype)).cuda()
    before, path = ops.LAUNCHES, ops.gemm_path(xt, yt)
    by_path = ops.PATH_LAUNCHES[path]
    got = ops.gemm(xt, yt)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    assert ops.PATH_LAUNCHES[path] == by_path + 1
    want = ref.gemm_ref(xt, yt)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dtype])
