"""Port parity: MoE (``layers.apply_moe`` and its router) against the
reference, at deepseek-v3-671b-smoke widths (8 experts of 64, top-2,
sigmoid router, 1 shared expert).

The reference's ``init_moe`` params cross over through numpy and the same
numpy activations go through both packages.  The dispatch must be the
reference's exactly: the same top-k picks, the same stable sort by expert,
the same capacity C = ceil(T·k/E·cf) per batch row and therefore the same
dropped tokens.  The smoke config is dropless (cf = 8); the production
factor 1.25 is also run, on enough tokens that some experts overflow, and
the test asserts that some (token, expert) pairs dropped.  Outputs and the
aux loss are held to f32 rtol/atol 1e-5 (the same sums in another order).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models.registry import get_config as jax_get_config
from repro_torch.models import layers as L
from repro_torch.models.registry import get_config

ARCH = "deepseek-v3-671b-smoke"
RTOL = ATOL = 1e-5


@pytest.fixture(scope="module")
def cfgs():
    return get_config(ARCH), jax_get_config(ARCH)


@pytest.fixture(scope="module")
def moe_params(cfgs):
    _, jcfg = cfgs
    jp = JL.init_moe(jax.random.key(3), jcfg)
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp), jp


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=ATOL)


def _with_cf(cfg, cf):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def _dropped(p, cfg, x):
    """(token, expert) picks past their expert's capacity, counted from
    the router's picks the way the dispatch counts them: per batch row, in
    (t, k) order."""
    mo = cfg.moe
    B, T, D = x.shape
    C = max(1, int(math.ceil(T * mo.top_k / mo.num_experts
                             * mo.capacity_factor)))
    _, idx, _ = L._router_gates(p, mo, x.reshape(B * T, D))
    idx = idx.reshape(B, T * mo.top_k)
    return sum(max(0, int((idx[b] == e).sum()) - C)
               for b in range(B) for e in range(mo.num_experts))


def test_init_moe_shapes_and_dtypes_match_reference(cfgs, moe_params):
    cfg, _ = cfgs
    ours = L.init_moe(cfg, device="cpu", generator=torch.Generator())
    spec = lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1])
    assert jax.tree.map(spec, ours) == jax.tree.map(spec, moe_params[0])
    assert ours["router"]["w"].dtype == torch.float32
    meta = L.init_moe(cfg, device="meta", generator=None)
    assert jax.tree.map(spec, meta) == jax.tree.map(spec, ours)


def test_router_gates_match_reference(cfgs, moe_params):
    cfg, jcfg = cfgs
    p, jp = moe_params
    x = np.random.default_rng(0).standard_normal(
        (24, cfg.d_model)).astype(np.float32)
    g, idx, sc = L._router_gates(p, cfg.moe, torch.from_numpy(x))
    jg, jidx, jsc = JL._router_gates(jp, jcfg.moe, jnp.asarray(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(g, jg)
    _close(sc, jsc)
    _close(L.moe_load_balance_loss(sc, idx, cfg.moe.num_experts),
           JL.moe_load_balance_loss(jsc, jidx, jcfg.moe.num_experts))


@pytest.mark.parametrize("cf,B,T", [(None, 2, 7), (None, 8, 1),
                                    (1.25, 3, 16), (1.25, 1, 64)])
def test_apply_moe_matches_reference(cfgs, moe_params, cf, B, T):
    """(None, *): the smoke config's dropless factor; (8, 1): a decode
    step's shape; (1.25, *): GShard capacity, tokens drop."""
    cfg, jcfg = cfgs
    if cf is not None:
        cfg, jcfg = _with_cf(cfg, cf), _with_cf(jcfg, cf)
    p, jp = moe_params
    x = np.random.default_rng(B * 100 + T).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)
    y, aux = L.apply_moe(p, cfg, torch.from_numpy(x))
    jy, jaux = JL.apply_moe(jp, jcfg, jnp.asarray(x))
    _close(y, jy)
    _close(aux, jaux)
    drops = _dropped(p, cfg, torch.from_numpy(x))
    if cf == 1.25:
        assert drops > 0, "capacity factor 1.25 dropped nothing"
    else:
        assert drops == 0


def test_apply_moe_drops_only_overflow(cfgs, moe_params):
    """A dropped pick contributes nothing: with every token routed to the
    same two experts and capacity 1, only each expert's first token is
    served by the routed experts, and the rest get the shared expert
    alone."""
    cfg, _ = cfgs
    cfg = _with_cf(cfg, 1.0)
    p, _ = moe_params
    p = dict(p)
    router = torch.full_like(p["router"]["w"], -5.0)
    router[:, :2] = 5.0                       # experts 0 and 1 always win
    p["router"] = {"w": router}
    T = 4                                     # C = ceil(4*2/8*1) = 1
    x = torch.ones(1, T, cfg.d_model)
    y, _ = L.apply_moe(p, cfg, x)
    shared = L.apply_mlp(p["shared"], cfg, x.reshape(T, -1))
    assert not torch.allclose(y[0, 0], shared[0])
    torch.testing.assert_close(y[0, 1:], shared[1:], rtol=0, atol=0)
