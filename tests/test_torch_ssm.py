"""Port parity: the recurrent blocks (``models/ssm.py``) on the CPU.

Mamba (Jamba's layer) at jamba-v0.1-52b-smoke and the xLSTM cells (mLSTM,
sLSTM) at xlstm-1.3b-smoke, with the reference's parameters and inputs
drawn from numpy seeds, in f32:

* ``_causal_conv`` with and without a state and an ``update_mask`` whose
  rows consumed all, some and none of their tokens: outputs within 1e-6
  (the same K products summed in the same order; XLA may contract a
  multiply-add) and the new conv state bit for bit (it is a gather);
* each block's forward from a zero state, its one-token step from a
  carried state, and a masked forward from a carried state: outputs and
  every final state leaf within ``ATOL`` (the same recurrence; the two
  libraries' exp/log1p/sigmoid and reduction orders differ by an ulp or
  so per step);
* a row the mask gates off for the whole chunk (``valid == 0``) keeps its
  incoming state bit for bit, in the port as in the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JS
from repro.models.registry import get_config as jax_get_config
from repro_torch.models import ssm as S
from repro_torch.models.registry import get_config

ATOL = 2e-5
CONV_ATOL = 1e-6
VALID = [7, 3, 0]             # tokens each row consumes in the masked pass

BLOCKS = {
    "mamba": ("jamba-v0.1-52b-smoke", JS.init_mamba, JS.mamba_forward,
              JS.mamba_step, S.mamba_forward, S.mamba_step),
    "mlstm": ("xlstm-1.3b-smoke", JS.init_mlstm, JS.mlstm_forward,
              JS.mlstm_step, S.mlstm_forward, S.mlstm_step),
    "slstm": ("xlstm-1.3b-smoke", JS.init_slstm, JS.slstm_forward,
              JS.slstm_step, S.slstm_forward, S.slstm_step),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops, which a thread pool per worker only slows when the
    suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _mask(T):
    return np.arange(T)[None, :] < np.asarray(VALID)[:, None]


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_causal_conv(with_state, masked):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    st = rng.standard_normal((3, 3, 12)).astype(np.float32) \
        if with_state else None
    m = _mask(7) if masked else None
    y, ns = S._causal_conv(
        torch.from_numpy(x), torch.from_numpy(w),
        None if st is None else torch.from_numpy(st),
        None if m is None else torch.from_numpy(m))
    jy, jns = JS._causal_conv(jnp.asarray(x), jnp.asarray(w),
                              None if st is None else jnp.asarray(st),
                              None if m is None else jnp.asarray(m))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                               atol=CONV_ATOL)
    np.testing.assert_array_equal(ns.numpy(), np.asarray(jns))
    if masked:
        # row 2 consumed nothing: its state is the incoming one
        want = st[2] if with_state else np.zeros((3, 12), np.float32)
        np.testing.assert_array_equal(ns[2].numpy(), want)


@pytest.fixture(scope="module", params=sorted(BLOCKS))
def block(request):
    arch, jinit, jfwd, jstep, fwd, step = BLOCKS[request.param]
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    jp = jinit(jax.random.key(3), jcfg)
    return request.param, cfg, jcfg, jp, _t(jp), jfwd, jstep, fwd, step


def _close_state(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.from_numpy(np.array(want[k])).dtype
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=ATOL, err_msg=k)


def test_forward_step_and_masked_forward(block):
    kind, cfg, jcfg, jp, p, jfwd, jstep, fwd, step = block
    rng = np.random.default_rng(1)
    u = rng.standard_normal((3, 7, cfg.d_model)).astype(np.float32)
    with torch.no_grad():
        # forward from the zero state
        y, st = fwd(p, cfg, torch.from_numpy(u))
        jy, jst = jfwd(jp, jcfg, jnp.asarray(u))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                                   atol=ATOL)
        _close_state(st, jst)
        # f32 state (the conv window follows the model dtype: f32 here)
        assert all(v.dtype == torch.float32 for k, v in st.items())

        # one decode step from the carried (reference) state
        jst_np = _np(jst)
        u1 = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
        y1, st1 = step(p, cfg, torch.from_numpy(u1), _t(jst_np))
        jy1, jst1 = jstep(jp, jcfg, jnp.asarray(u1), jst)
        np.testing.assert_allclose(y1.numpy(), np.asarray(jy1), rtol=0,
                                   atol=ATOL)
        _close_state(st1, jst1)

        # masked forward from the carried state: rows consume 7, 3, 0
        m = _mask(7)
        ym, stm = fwd(p, cfg, torch.from_numpy(u), _t(jst_np),
                      update_mask=torch.from_numpy(m))
        jym, jstm = jfwd(jp, jcfg, jnp.asarray(u), jst,
                         update_mask=jnp.asarray(m))
    for b, v in enumerate(VALID):       # outputs past a row's valid: garbage
        np.testing.assert_allclose(ym[b, :v].numpy(), np.asarray(jym)[b, :v],
                                   rtol=0, atol=ATOL)
    _close_state(stm, jstm)
    for k, leaf in stm.items():         # the gated-off row kept its state
        np.testing.assert_array_equal(leaf[2].numpy(), jst_np[k][2])
        np.testing.assert_array_equal(np.asarray(jstm[k])[2], jst_np[k][2])


def test_softplus_is_jax_softplus():
    """Within an ulp or so everywhere, with no linear threshold (torch's
    ``softplus`` returns x itself past 20).  Inputs stop short of -87,
    where the result is subnormal and XLA:CPU flushes it to zero
    (ROADMAP C3)."""
    x = np.concatenate([np.linspace(-40, 40, 801),
                        [0.0, -0.0, 1e-30, 88.0, -80.0]]).astype(np.float32)
    got = S._softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=0)
