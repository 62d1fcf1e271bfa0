"""Port parity: MLA (B8's plain version and ``layers.apply_mla``) against
the reference, at deepseek-v3-671b-smoke widths (H 4, r 32, dr 16).

* B8's plain version (``paged_mla_attention_ref``) and the public op on
  CPU tensors are held to the reference's ``paged_mla_attention_ref`` and
  to its Pallas kernel in interpret mode, on the same numpy inputs: ragged
  lengths over a shuffled pool whose unreferenced blocks are NaN.  f32
  atol 1e-5 (the same arithmetic summed in another order); bf16 atol 2e-2,
  one bf16 step on outputs of magnitude <= 4 (the two packages may round
  a bf16 score product differently).
* ``apply_mla`` with the reference's params: the whole-sequence forward,
  chunked paged prefill and paged decode under both lowerings ("ref":
  gather then ``_mla_absorbed_decode``; "auto": the op above), held to the
  reference within f32 rtol/atol 1e-5, and the latent pools to 1e-5.

The CUDA kernel runs only on the card: its test is marked ``cuda`` and
skips without one (``chip_smoke.py`` holds it to the plain version there).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.kernel import \
    paged_mla_attention_pallas as jax_mla_pallas
from repro.kernels.paged_attention.ops import \
    paged_mla_attention as jax_mla_op
from repro.kernels.paged_attention.ref import \
    paged_mla_attention_ref as jax_mla_ref
from repro.models import layers as JL
from repro.models.registry import get_config as jax_get_config
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import paged_mla_attention_ref
from repro_torch.models import layers as L
from repro_torch.models.registry import get_config

ARCH = "deepseek-v3-671b-smoke"
F32_ATOL = 1e-5
BF16_ATOL = 2e-2
RTOL = ATOL = 1e-5


def _mla_case(seed=0, lengths=(1, 16, 17, 30), H=4, r=32, dr=16, bs=4,
              spare=3):
    """Latent pools with each row's blocks scattered through them; the
    tables' unused entries are the sentinel block 0.  Every slot no row may
    attend holds garbage: random values where the gather of the plain
    version reads them (the sentinel block, past-length slots of a row's
    blocks), NaN in the ``spare`` blocks no table references."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    n = max(-(-L_ // bs) for L_ in lengths) + 1
    need = sum(-(-L_ // bs) for L_ in lengths)
    N = 1 + need + spare
    perm = rng.permutation(np.arange(1, N))
    tables = np.zeros((B, n), np.int32)
    ckv = rng.standard_normal((N, bs, r)).astype(np.float32)
    kr = rng.standard_normal((N, bs, dr)).astype(np.float32)
    used = 0
    for b, L_ in enumerate(lengths):
        nb = -(-L_ // bs)
        tables[b, :nb] = perm[used:used + nb]
        used += nb
    unreferenced = perm[used:]
    ckv[unreferenced] = np.nan
    kr[unreferenced] = np.nan
    qe = rng.standard_normal((B, H, r)).astype(np.float32)
    qr = rng.standard_normal((B, H, dr)).astype(np.float32)
    return qe, qr, ckv, kr, tables, np.asarray(lengths, np.int32)


def _torch(*arrays, dtype=None):
    out = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    return [t.to(dtype) if dtype is not None and t.is_floating_point()
            else t for t in out]


def _jax(*arrays, dtype=None):
    out = [jnp.asarray(a) for a in arrays]
    return [a.astype(dtype) if dtype is not None and
            jnp.issubdtype(a.dtype, jnp.floating) else a for a in out]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_ref_matches_reference_kernel_and_ref(dtype):
    qe, qr, ckv, kr, tables, lens = _mla_case(seed=1)
    scale = 1.0 / math.sqrt(48)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = paged_mla_attention_ref(*_torch(qe, qr, ckv, kr, tables, lens,
                                          dtype=tdt), scale=scale)
    assert got.dtype == tdt and tuple(got.shape) == qe.shape
    got = got.float().numpy()
    assert np.isfinite(got).all()          # NaN blocks are never read
    args = _jax(qe, qr, ckv, kr, tables, lens, dtype=jdt)
    want_ref = np.asarray(jax_mla_ref(*args, scale=scale), np.float32)
    want_kernel = np.asarray(jax_mla_pallas(*args, scale=scale,
                                            interpret=True), np.float32)
    atol = F32_ATOL if dtype == "float32" else BF16_ATOL
    np.testing.assert_allclose(got, want_ref, rtol=0, atol=atol)
    np.testing.assert_allclose(got, want_kernel, rtol=0, atol=atol)


def test_mla_ref_ignores_unreferenced_blocks():
    """Poisoned (NaN) blocks that no table references change nothing: the
    same rows over a pool with those blocks zeroed give the same bits, and
    so does other garbage in the masked past-length slots."""
    qe, qr, ckv, kr, tables, lens = _mla_case(seed=2)
    scale = 0.125
    dirty = paged_mla_attention_ref(*_torch(qe, qr, ckv, kr, tables, lens),
                                    scale=scale)
    assert np.isnan(ckv).any() and torch.isfinite(dirty).all()
    clean = paged_mla_attention_ref(
        *_torch(qe, qr, np.nan_to_num(ckv), np.nan_to_num(kr), tables,
                lens), scale=scale)
    assert torch.equal(dirty, clean)
    bs = ckv.shape[1]
    ckv2, kr2 = ckv.copy(), kr.copy()
    for b, L_ in enumerate(lens):
        blk, t = tables[b, (L_ - 1) // bs], (L_ - 1) % bs
        ckv2[blk, t + 1:] = 1e3                  # past-length slots
        kr2[blk, t + 1:] = -1e3
    ckv2[0], kr2[0] = 7.0, 7.0                   # the sentinel block
    again = paged_mla_attention_ref(*_torch(qe, qr, ckv2, kr2, tables,
                                            lens), scale=scale)
    assert torch.equal(dirty, again)


def test_mla_op_matches_reference_op():
    """The public op: [B,1,H,*] queries, the [N,bs,1,dr] rope pool as
    cached, per-row offsets (lengths = offset + 1)."""
    qe, qr, ckv, kr, tables, lens = _mla_case(seed=3, lengths=(5, 1, 12))
    off = lens - 1
    kr4 = kr[:, :, None, :]
    scale = 1.0 / math.sqrt(48)
    launches = ops.MLA_LAUNCHES
    got = ops.paged_mla_attention(
        *_torch(qe[:, None], qr[:, None], ckv, kr4, tables, off),
        scale=scale)
    assert ops.MLA_LAUNCHES == launches          # CPU tensors never launch
    want = jax_mla_op(*_jax(qe[:, None], qr[:, None], ckv, kr4, tables,
                            off), scale=scale, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=F32_ATOL)
    with pytest.raises(ValueError, match="decode-only"):
        ops.paged_mla_attention(*_torch(np.repeat(qe[:, None], 2, 1),
                                        np.repeat(qr[:, None], 2, 1), ckv,
                                        kr4, tables, off), scale=scale)


def test_mla_kernel_wrapper_refuses_cpu_tensors():
    qe, qr, ckv, kr, tables, lens = _mla_case(seed=4)
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_mla_attention_kernel(*_torch(qe, qr, ckv, kr, tables,
                                               lens), scale=1.0)


# ---------------------------------------------------------------------------
# apply_mla
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cfgs():
    return get_config(ARCH), jax_get_config(ARCH)


@pytest.fixture(scope="module")
def mla_params(cfgs):
    _, jcfg = cfgs
    jp = JL.init_mla(jax.random.key(7), jcfg)
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp), jp


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=ATOL)


def test_init_mla_shapes_match_reference(cfgs, mla_params):
    cfg, _ = cfgs
    ours = L.init_mla(cfg, device="cpu", generator=torch.Generator())
    shapes = jax.tree.map(lambda t: tuple(t.shape), ours)
    assert shapes == jax.tree.map(lambda t: tuple(t.shape), mla_params[0])


def test_apply_mla_forward_matches_reference(cfgs, mla_params):
    cfg, jcfg = cfgs
    p, jp = mla_params
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    pos = np.arange(9, dtype=np.int32)
    out, cache = L.apply_mla(p, cfg, torch.from_numpy(x),
                             positions=torch.from_numpy(pos))
    jout, jcache = JL.apply_mla(jp, jcfg, jnp.asarray(x),
                                positions=jnp.asarray(pos))
    _close(out, jout)
    _close(cache["c_kv"], jcache["c_kv"])
    _close(cache["k_rope"], jcache["k_rope"])


@pytest.mark.parametrize("kernel", ["ref", "auto"])
def test_apply_mla_paged_prefill_then_decode(cfgs, mla_params, kernel):
    """Two rows prefill in chunks of 4 (row 1 right-aligned at a nonzero
    offset), then three batched decode steps with per-row offsets and a
    masked third row on an all-sentinel table."""
    cfg, jcfg = cfgs
    p, jp = mla_params
    m = cfg.mla
    N, bs, n, C = 12, 4, 4, 4
    rng = np.random.default_rng(6)
    ckv = np.zeros((N, bs, m.kv_lora_rank), np.float32)
    kr = np.zeros((N, bs, 1, m.qk_rope_head_dim), np.float32)
    cache = {"c_kv": torch.from_numpy(ckv.copy()),
             "k_rope": torch.from_numpy(kr.copy())}
    jcache = {"c_kv": jnp.asarray(ckv), "k_rope": jnp.asarray(kr)}
    tables = np.zeros((3, n), np.int32)
    tables[0, :3] = [4, 9, 2]
    tables[1, :2] = [7, 3]
    for row, (start, T) in enumerate([(0, 4), (4, 4), (3, 4)]):
        r = min(row, 1)
        x = rng.standard_normal((1, T, cfg.d_model)).astype(np.float32)
        pos = (start + np.arange(T, dtype=np.int32))[None]
        tab = tables[r:r + 1]
        out, cache = L.apply_mla(
            p, cfg, torch.from_numpy(x), positions=torch.from_numpy(pos),
            kv_cache=cache, cache_offset=start,
            block_tables=torch.from_numpy(tab))
        jout, jcache = JL.apply_mla(
            jp, jcfg, jnp.asarray(x), positions=jnp.asarray(pos),
            kv_cache=jcache, cache_offset=jnp.asarray(start, jnp.int32),
            block_tables=jnp.asarray(tab))
        _close(out, jout)
    lengths = np.array([8, 7, n * bs - 1], np.int32)
    jkernel = "pallas" if kernel == "auto" else "ref"
    for step in range(3):
        x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
        off = lengths + 0
        off[:2] += step
        out, cache = L.apply_mla(
            p, cfg, torch.from_numpy(x),
            positions=torch.from_numpy(off[:, None]), kv_cache=cache,
            cache_offset=torch.from_numpy(off),
            block_tables=torch.from_numpy(tables), paged_kernel=kernel)
        jout, jcache = JL.apply_mla(
            jp, jcfg, jnp.asarray(x), positions=jnp.asarray(off[:, None]),
            kv_cache=jcache, cache_offset=jnp.asarray(off),
            block_tables=jnp.asarray(tables), paged_kernel=jkernel)
        _close(out[:2], np.asarray(jout)[:2])
    for leaf in ("c_kv", "k_rope"):          # block 0: the sentinel
        _close(cache[leaf][1:], np.asarray(jcache[leaf])[1:])


def test_apply_mla_rejects_unknown_lowering(cfgs, mla_params):
    cfg, _ = cfgs
    p, _ = mla_params
    m = cfg.mla
    cache = {"c_kv": torch.zeros(2, 4, m.kv_lora_rank),
             "k_rope": torch.zeros(2, 4, 1, m.qk_rope_head_dim)}
    with pytest.raises(ValueError, match="paged_kernel"):
        L.apply_mla(p, cfg, torch.zeros(1, 1, cfg.d_model),
                    positions=torch.zeros(1, 1, dtype=torch.int32),
                    kv_cache=cache, cache_offset=0,
                    block_tables=torch.ones(1, 1, dtype=torch.int32),
                    paged_kernel="pallas")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,r,dr,H,atol", [
    (torch.float32, 32, 16, 4, F32_ATOL),
    (torch.bfloat16, 512, 64, 128, BF16_ATOL)])
def test_cuda_mla_kernel_launches_and_matches_ref(dtype, r, dr, H, atol):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode; "
                    "run on the card with pytest -m cuda)")
    qe, qr, ckv, kr, tables, lens = _mla_case(
        seed=8, lengths=(1, 16, 17, 336), H=H, r=r, dr=dr, bs=16)
    dev = torch.device("cuda")
    args = [t.to(dev) for t in _torch(qe, qr, ckv, kr, tables, lens,
                                      dtype=dtype)]
    launches = ops.MLA_LAUNCHES
    got = ops.paged_mla_attention_kernel(*args, scale=0.07)
    torch.cuda.synchronize()
    assert ops.MLA_LAUNCHES == launches + 1
    want = paged_mla_attention_ref(*args, scale=0.07)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=atol)
