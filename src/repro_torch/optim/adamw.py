"""AdamW hyper-parameters and learning-rate schedule (port of
``repro/optim/adamw.py``).

The BSP trainer applies AdamW itself, on flat f32 ZeRO-1 shards
(``runtime.trainer._adamw_flat``), so only the config and the schedule are
ported here.  The pytree ``init``/``apply_updates`` of the reference belong
to the GSPMD tier, which has no counterpart on one device yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

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
