"""Port parity: the paged-attention decode op (B7) against the reference.

The port's ``ref.py`` and its public op on CPU tensors are held to the
reference's ``paged_attention`` (the Pallas kernel, in interpret mode on
the CPU) and to its ``paged_attention_ref``, on the same numpy inputs.
Tolerance f32 rtol 1e-5, atol 1e-6: the same arithmetic, summed in another
order.  The CUDA kernel itself runs only on the card: its test is marked
``cuda`` and skips without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.ops import paged_attention as jax_paged
from repro.kernels.paged_attention.ref import \
    paged_attention_ref as jax_paged_ref
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

RTOL, ATOL = 1e-5, 1e-6


def _case(seed=0, B=3, n=4, N=9, bs=4, Hkv=2, G=3, d=16, dv=16,
          offsets=None):
    """Ragged rows over a shuffled pool; unused table entries are the
    sentinel block 0 (rows shorter than n*bs)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, Hkv * G, d)).astype(np.float32)
    kp = rng.standard_normal((N, bs, Hkv, d)).astype(np.float32)
    vp = rng.standard_normal((N, bs, Hkv, dv)).astype(np.float32)
    if offsets is None:
        offsets = rng.integers(0, n * bs, size=(B,))
    offsets = np.asarray(offsets, np.int32)
    perm = rng.permutation(np.arange(1, N))
    tables = np.zeros((B, n), np.int32)
    used = 0
    for b in range(B):
        nb = offsets[b] // bs + 1
        take = perm[used % len(perm):][:nb]
        if len(take) < nb:
            take = rng.choice(np.arange(1, N), size=nb)
        tables[b, :nb] = take
        used += nb
    return q, kp, vp, tables, offsets


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("softcap", [None, 50.0])
def test_op_matches_reference_kernel_and_ref(window, softcap):
    q, kp, vp, tables, off = _case(seed=1)
    out = ops.paged_attention(*_torch(q, kp, vp, tables, off),
                              window=window, softcap=softcap).numpy()
    jk = np.asarray(jax_paged(jnp.asarray(q), jnp.asarray(kp),
                              jnp.asarray(vp), jnp.asarray(tables),
                              jnp.asarray(off), window=window,
                              softcap=softcap))
    B, _, Hq, d = q.shape
    Hkv = kp.shape[2]
    qh = q[:, 0].reshape(B, Hkv, Hq // Hkv, d)
    jr = np.asarray(jax_paged_ref(jnp.asarray(qh), jnp.asarray(kp),
                                  jnp.asarray(vp), jnp.asarray(tables),
                                  jnp.asarray(off + 1), scale=d ** -0.5,
                                  window=window, softcap=softcap))
    assert out.shape == jk.shape == (B, 1, Hq, vp.shape[-1])
    np.testing.assert_allclose(out, jk, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out, jr.reshape(out.shape), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("seed,G,d,dv", [(2, 1, 8, 8), (3, 4, 32, 16)])
def test_ref_matches_reference_ref_shapes(seed, G, d, dv):
    q, kp, vp, tables, off = _case(seed=seed, G=G, d=d, dv=dv)
    B, _, Hq, _ = q.shape
    Hkv = kp.shape[2]
    qh = q[:, 0].reshape(B, Hkv, G, d)
    lengths = (off + 1).astype(np.int32)
    out = paged_attention_ref(*_torch(qh, kp, vp, tables, lengths),
                              scale=0.3, window=5, softcap=50.0).numpy()
    want = np.asarray(jax_paged_ref(jnp.asarray(qh), jnp.asarray(kp),
                                    jnp.asarray(vp), jnp.asarray(tables),
                                    jnp.asarray(lengths), scale=0.3,
                                    window=5, softcap=50.0))
    np.testing.assert_allclose(out, want, rtol=RTOL, atol=ATOL)


def test_ragged_lengths_including_full_and_single():
    """Length 1 (offset 0) and the full table span (offset n*bs-1: the
    inactive-row geometry) both match the reference kernel."""
    n, bs = 4, 4
    q, kp, vp, tables, off = _case(seed=4, n=n, bs=bs,
                                   offsets=[0, n * bs - 1, 6])
    out = ops.paged_attention(*_torch(q, kp, vp, tables, off),
                              softcap=50.0).numpy()
    jk = np.asarray(jax_paged(jnp.asarray(q), jnp.asarray(kp),
                              jnp.asarray(vp), jnp.asarray(tables),
                              jnp.asarray(off), softcap=50.0))
    np.testing.assert_allclose(out, jk, rtol=RTOL, atol=ATOL)


def test_sentinel_and_unreferenced_blocks_are_ignored():
    """Poisoning the sentinel block and every block no table references
    leaves the output unchanged."""
    q, kp, vp, tables, off = _case(seed=5, N=16)
    base = ops.paged_attention(*_torch(q, kp, vp, tables, off)).numpy()
    live = set()
    for b in range(tables.shape[0]):
        live |= set(tables[b, :off[b] // kp.shape[1] + 1].tolist())
    dead = [i for i in range(kp.shape[0]) if i not in live]
    assert 0 in dead
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[dead] = 1e9
    vp2[dead] = 1e9
    out = ops.paged_attention(*_torch(q, kp2, vp2, tables, off)).numpy()
    np.testing.assert_array_equal(out, base)


def test_invariant_to_block_placement():
    """Relocating the physical blocks (and rewriting the tables to match)
    does not change the output."""
    q, kp, vp, tables, off = _case(seed=6)
    out = ops.paged_attention(*_torch(q, kp, vp, tables, off)).numpy()
    N = kp.shape[0]
    perm = np.concatenate([[0], np.random.default_rng(0).permutation(
        np.arange(1, N))])
    inv = np.argsort(perm)
    kp2, vp2 = kp[perm], vp[perm]
    tables2 = inv[tables].astype(np.int32)
    out2 = ops.paged_attention(*_torch(q, kp2, vp2, tables2, off)).numpy()
    np.testing.assert_allclose(out2, out, rtol=RTOL, atol=ATOL)


def test_scalar_offset_broadcasts():
    q, kp, vp, tables, _ = _case(seed=7, offsets=[5, 5, 5])
    vec = ops.paged_attention(*_torch(q, kp, vp, tables,
                                      np.full(3, 5, np.int32))).numpy()
    sca = ops.paged_attention(*_torch(q, kp, vp, tables), 5).numpy()
    np.testing.assert_array_equal(sca, vec)


def test_rejects_multi_token():
    q, kp, vp, tables, off = _case(seed=0)
    q2 = np.concatenate([q, q], axis=1)
    with pytest.raises(ValueError, match="decode-only"):
        ops.paged_attention(*_torch(q2, kp, vp, tables, off))


@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("n", [1, 21, 512])
@pytest.mark.parametrize("B", [1, 8])
def test_plan_splits_covers_every_page_once(B, n, bs):
    """The split kernels' plan, for B7's grid (4 KV heads, 3 blocks an SM)
    and B8's (8 head blocks, 2 an SM; 1 an SM for wide heads), and the
    chunks a block cuts from its row's length on the card
    (``split_ranges``): at least one split, within one wave of 132 SMs
    unless the rows alone exceed it; at every length and window, every
    live page of the row in exactly one chunk, no chunk wider than the
    plan's ``pages`` (its table in shared memory), at least one chunk
    live where the length lies within the table, and at least MIN_SPLIT_POSITIONS positions a live chunk but the
    last."""
    least = ops.min_split_pages(bs)
    lengths = sorted({1, 2, bs, bs + 1, 33, 300, n * bs - 1, n * bs,
                      n * bs + 5} - {0})
    for heads, per_sm in ((4, 3), (8, 2), (64, 1)):
        splits, pages = ops.plan_splits(B, heads, n, bs, 132, per_sm)
        assert type(splits) is int and type(pages) is int
        assert 1 <= splits <= ops.MAX_SPLITS and 1 <= pages <= n
        assert B * heads * splits <= max(B * heads, per_sm * 132)
        assert splits == 1 or n >= splits * least - least + 1
        for L in lengths:
            for window in (None, 1, 100, 4096):
                first = max(0, L - window) if window else 0
                live = set(range(first // bs, -(-min(L, n * bs) // bs)))
                ranges = ops.split_ranges(L, n, bs, splits, window)
                assert len(ranges) == splits
                owned = [j for a, z in ranges for j in range(a, z)]
                assert sorted(owned) == sorted(live), (L, window)
                full = [z - a for a, z in ranges if a < z]
                assert max(full, default=0) <= pages
                assert full or L > n * bs       # a decode row has a page
                assert all(w >= least for w in full[:-1])
def test_plan_splits_takes_host_ints_only():
    """A plan never reads the card: a tensor (even one on the CPU, even the
    lengths) or a numpy integer is refused, and a count below 1 too."""
    ok = ops.plan_splits(8, 4, 21, 16, 132, 3)
    assert ok == (11, 2)
    for i, bad in ((0, torch.tensor(8)), (2, torch.tensor(21)),
                   (2, np.int64(21)), (4, 132.0), (5, True)):
        args = [8, 4, 21, 16, 132, 3]
        args[i] = bad
        with pytest.raises(TypeError, match="host ints"):
            ops.plan_splits(*args)
    with pytest.raises(ValueError):
        ops.plan_splits(8, 4, 0, 16, 132, 3)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never runs the plain version: a CPU tensor is an
    error there (only the public op dispatches CPU tensors to ref.py)."""
    q, kp, vp, tables, off = _case(seed=0)
    B, _, Hq, d = q.shape
    qh = q[:, 0].reshape(B, kp.shape[2], -1, d)
    launches = ops.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_attention_kernel(*_torch(qh, kp, vp, tables,
                                           (off + 1).astype(np.int32)),
                                   scale=d ** -0.5)
    assert ops.LAUNCHES == launches


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
def test_cuda_kernel_launches_and_matches_ref(dtype, atol):
    """On the card: CUDA tensors go through the kernel (the launch count
    moves) and agree with ref.py on the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card via chip_smoke / "
                    "pytest -m cuda)")
    q, kp, vp, tables, off = _case(seed=8, B=4, n=8, N=40, bs=16, Hkv=4,
                                   G=2, d=256, dv=256)
    dev = torch.device("cuda")
    tq, tk, tv = (torch.from_numpy(a).to(dev, dtype) for a in (q, kp, vp))
    tt = torch.from_numpy(tables).to(dev)
    to = torch.from_numpy(off).to(dev)
    before = ops.LAUNCHES
    out = ops.paged_attention(tq, tk, tv, tt, to, window=40, softcap=50.0)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    want = ops.paged_attention(tq.cpu(), tk.cpu(), tv.cpu(), tt.cpu(),
                               to.cpu(), window=40, softcap=50.0)
    torch.testing.assert_close(out.float().cpu(), want.float(), rtol=0,
                               atol=atol)
