"""Port parity: ``transformer.set_remat("dots")``, the reference's
``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims``.

Each scanned unit runs under ``torch.utils.checkpoint`` with a selective
policy that keeps the outputs of the matmuls with no batch dimension and
recomputes the rest in the backward:

  * gradients under "dots" equal those under "none" and "block" bit for
    bit (the recompute runs the same ops on the same inputs), for
    gemma2-2b-smoke and deepseek-v3-671b-smoke in f32, and the reference's
    own under its ``set_remat("dots")`` at ``tests/test_torch_train.py``'s
    bounds (atol 2e-5 on the loss; rtol 1e-3, atol 1e-5 on gradients: the
    same arithmetic summed in another order);
  * the policy keeps exactly the no-batch matmuls: a forward and backward
    under "dots" runs as many ``mm`` as under "none" and as many ``bmm``
    (attention's and the experts' batched dots, recomputed) as under
    "block", more than under "none"; a ``[B,T,D] @ [D,F]`` that ``matmul``
    lowers to a ``bmm`` over an expanded weight is a no-batch dot;
  * the traced FLOPs order none < dots < block;
  * an unknown mode raises ``ValueError``.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models import transformer as JT
from repro.models.registry import get_config as jget_config
from repro_torch.launch import hlo_analysis as H
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_config
from repro_torch.weights import from_jax_params, reference_leaves

ARCHS = ["gemma2-2b-smoke", "deepseek-v3-671b-smoke"]
MODES = ("none", "block", "dots")
B, TLEN = 2, 16


@pytest.fixture(autouse=True)
def _restore_remat():
    yield
    T.set_remat("block")
    JT.set_remat("block")


def _batch(vocab, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, vocab, (B, TLEN)).astype(np.int32)
    labels[0, :3] = -1
    return {"tokens": rng.integers(0, vocab, (B, TLEN)).astype(np.int32),
            "labels": labels}


@pytest.fixture(scope="module")
def ref_params():
    return {a: JT.init_params(jget_config(a), jax.random.key(0))
            for a in ARCHS}


def _port(arch, ref_params):
    cfg = get_config(arch)
    params = from_jax_params(jax.tree.map(np.asarray, ref_params[arch]),
                             cfg, device="cpu")
    leaves = reference_leaves(params, cfg)
    flat = [t.requires_grad_(True) for leaf in leaves for t in leaf.parts]
    return cfg, params, leaves, flat


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] += 1
        return func(*args, **(kwargs or {}))


def _loss_grads(cfg, params, flat, batch, mode):
    T.set_remat(mode)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with _OpCount() as ops:
        loss, _ = T.loss_fn(params, cfg, tb)
        grads = torch.autograd.grad(loss, flat)
    return loss, grads, ops.n


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_grads_equal_none_and_block_and_keep_no_batch_dots(
        arch, ref_params):
    cfg, params, _, flat = _port(arch, ref_params)
    batch = _batch(cfg.vocab_size)
    out = {m: _loss_grads(cfg, params, flat, batch, m) for m in MODES}
    for m in ("none", "block"):
        assert torch.equal(out["dots"][0], out[m][0])
        assert all(torch.equal(a, b) for a, b in zip(out["dots"][1],
                                                      out[m][1])), m
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    n = {m: out[m][2] for m in MODES}
    assert n["dots"][mm] == n["none"][mm] < n["block"][mm]
    assert n["none"][bmm] < n["dots"][bmm] == n["block"][bmm]


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_grads_match_reference_dots(arch, ref_params):
    cfg, params, leaves, flat = _port(arch, ref_params)
    batch = _batch(cfg.vocab_size, seed=1)
    JT.set_remat("dots")
    jcfg = jget_config(arch)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, jcfg, b), has_aux=True))(
        ref_params[arch], {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads, _ = _loss_grads(cfg, params, flat, batch, "dots")
    assert abs(loss.item() - float(jl)) <= 2e-5
    grads = iter(grads)
    for leaf, want in zip(leaves, jax.tree.leaves(jg)):
        got = torch.stack([next(grads) for _ in leaf.parts]) \
            if leaf.path.startswith("segments/") else next(grads)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-3, atol=1e-5, err_msg=leaf.path)


def test_traced_flops_order_none_dots_block():
    cfg = get_config("gemma2-2b-smoke")
    params = T.init_params(cfg, device="meta")
    flat = [t.requires_grad_(True) for leaf in reference_leaves(params, cfg)
            for t in leaf.parts]
    batch = {k: torch.empty(B, 64, dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}

    def step():
        loss, _ = T.loss_fn(params, cfg, batch)
        return torch.autograd.grad(loss, flat)

    flops = {}
    for m in MODES:
        T.set_remat(m)
        flops[m] = H.analyze_program(step).flops
    assert flops["none"] < flops["dots"] < flops["block"], flops


def test_matmul_over_an_expanded_weight_is_a_no_batch_dot():
    """``matmul`` of a [B,T,D] whose leading dims do not fold without a
    copy by a [D,F] weight goes through ``bmm`` over the weight expanded
    to [B,D,F] (stride 0) when no operand needs a gradient; the policy
    keeps it as jax keeps that dot."""
    x = torch.randn(8, 3, 4).transpose(0, 1)
    w = torch.randn(4, 5)
    seen = []

    class Spy(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
                seen.append((func, T._no_batch_dot(func, args)))
            return func(*args, **(kwargs or {}))

    with Spy():
        torch.matmul(x, w)
    assert seen == [(torch.ops.aten.bmm.default, True)]
    q = torch.randn(6, 3, 4)
    k = torch.randn(6, 4, 5)
    assert not T._no_batch_dot(torch.ops.aten.bmm.default, (q, k))
    assert T._no_batch_dot(torch.ops.aten.mm.default, (q[0], k[0]))
    assert T._no_batch_dot(torch.ops.aten.addmm.default,
                           (torch.randn(5), q[0], k[0]))


def test_set_remat_rejects_unknown_modes():
    with pytest.raises(ValueError):
        T.set_remat("bogus")
    T.set_remat("dots")
    assert T._REMAT == "dots"
    T.set_remat("block")
