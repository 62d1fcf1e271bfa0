"""AdamW optimizer (port of ``repro/optim/adamw.py``).

  * ``AdamWConfig`` and ``schedule`` (linear warmup, cosine decay) serve
    both tiers.  The BSP trainer applies AdamW itself, on flat f32 ZeRO-1
    shards (``runtime.trainer._adamw_flat``).
  * The pytree AdamW (``AdamWState``, ``init``, ``global_norm``,
    ``clip_by_global_norm``, ``apply_updates``) is the GSPMD tier's
    (``runtime.trainer.make_gspmd_train_step``): f32 moments by default,
    global-norm clipping, bias correction and decoupled weight decay, in
    the reference's order.  A tree is the port's nested dicts and lists of
    tensors; ``apply_updates`` updates params and moments IN PLACE (one
    copy of each fits the card; the reference returns new trees) and
    returns them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, List, NamedTuple, Tuple

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    state_dtype: torch.dtype = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 scalar
    mu: Any              # first-moment tree
    nu: Any              # second-moment tree


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []


def _map(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return tree


def init(params, cfg: AdamWConfig) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.state_dtype,
                                  device=p.device)
    dev = _leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=_map(params, zeros), nu=_map(params, zeros))


def schedule(step, cfg: AdamWConfig, device=None) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr_ratio·lr, as an f32 scalar
    (the reference computes it in f32 from an int32 step)."""
    f32 = dict(dtype=torch.float32, device=device)
    s = torch.as_tensor(step, **f32)
    warm = torch.clamp((s + 1) / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * decay


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    total = 0
    for leaf in _leaves(tree):
        total = total + torch.sum(torch.square(leaf.float()))
    return torch.sqrt(total)


def _clip_scale(norm, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (norm + 1e-12), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return _map(grads, lambda g: g * scale), norm


# elements of a leaf updated at a time
UPDATE_CHUNK = 1 << 26


def _update(p, g, m, n, scale, lr, bc1, bc2, cfg: AdamWConfig) -> None:
    """One leaf's (or a slice's) AdamW update, in place."""
    g = g.float()
    if scale is not None:
        g = g * scale
    b1, b2 = cfg.beta1, cfg.beta2
    m_new = b1 * m.float() + (1 - b1) * g
    n_new = b2 * n.float() + (1 - b2) * torch.square(g)
    mhat = m_new / bc1
    nhat = n_new / bc2
    delta = mhat / (torch.sqrt(nhat) + cfg.eps) + cfg.weight_decay * p.float()
    p.copy_(p.float() - lr * delta)
    m.copy_(m_new)
    n.copy_(n_new)


def apply_updates(params, grads, state: AdamWState, cfg: AdamWConfig
                  ) -> Tuple[Any, AdamWState, dict]:
    """One AdamW step; returns (params', state', metrics).  ``params``,
    ``grads``, ``state.mu`` and ``state.nu`` are trees of one structure;
    params and moments are updated in place (the reference's arithmetic:
    f32 grads, the global-norm clip, then per leaf the moments, the bias
    corrections and the decoupled weight decay)."""
    flat_p, flat_g = _leaves(params), _leaves(grads)
    flat_m, flat_n = _leaves(state.mu), _leaves(state.nu)
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_n):
        raise ValueError("params, grads and moments differ in structure")
    # each leaf's f32 gradient is made when it is used: one f32 copy of the
    # whole tree at a time never exists
    gnorm = global_norm(flat_g)
    scale = _clip_scale(gnorm, cfg.grad_clip) if cfg.grad_clip > 0 else None
    step = state.step + 1
    lr = schedule(state.step, cfg, device=state.step.device)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    with torch.no_grad():
        for p, g, m, n in zip(flat_p, flat_g, flat_m, flat_n):
            p, g, m, n = p.view(-1), g.reshape(-1), m.view(-1), n.view(-1)
            # elementwise, so chunking changes no bit; it bounds the
            # temporaries of a large leaf (an embedding) at a few GB
            for a in range(0, p.numel(), UPDATE_CHUNK):
                sl = slice(a, a + UPDATE_CHUNK)
                _update(p[sl], g[sl], m[sl], n[sl], scale, lr, bc1, bc2, cfg)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), metrics


def optimizer_bytes_per_param(cfg: AdamWConfig,
                              param_dtype=torch.bfloat16) -> int:
    """Memory budget helper: param + grad + 2 moments."""
    pb = torch.empty((), dtype=param_dtype).element_size()
    sb = torch.empty((), dtype=cfg.state_dtype).element_size()
    return pb + pb + 2 * sb
