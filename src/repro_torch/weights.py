"""Carry the reference's parameters (and paged caches) across to the port.

``from_jax_params`` converts a parameter tree; ``unstack_layers`` converts
any per-segment stacked tree, such as a paged cache.

The reference stacks each segment's unit as ``[reps, ...]`` leaves
(``segments[s][f"l{j}"]``) and scans them; the port keeps one dict per
layer.  Layer ``i`` of a segment whose unit has ``u`` kinds is unit entry
``j = i % u`` at repeat ``r = i // u`` — for gemma2 (``(("local",
"global"), 13)``) layer ``i`` is ``segments[0][f"l{i % 2}"][...][i // 2]``.
Paged caches are stacked the same way, so the same mapping serves both.

The input is the reference's tree with every leaf converted by
``np.asarray`` (numpy arrays; no JAX object crosses over).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device


def _to_tensor(a, device) -> torch.Tensor:
    a = np.array(a, order="C", copy=True)    # owned, writable
    if a.dtype.name == "bfloat16":      # ml_dtypes' bf16: reinterpret bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def layer_index(cfg: ArchConfig) -> List[tuple]:
    """``(segment, unit entry j, repeat r)`` of every layer, in order."""
    out = []
    for si, (unit, reps) in enumerate(cfg.segments()):
        for r in range(reps):
            for j in range(len(unit)):
                out.append((si, j, r))
    return out


def unstack_layers(segments: Sequence[Dict[str, Any]], cfg: ArchConfig,
                   device="cuda") -> List[Dict[str, Any]]:
    """Per-segment stacked trees (params or caches) → one tree per layer,
    as tensors on ``device`` (raises if CUDA is asked for and missing)."""
    device = resolve_device(device)
    return [_map(segments[si][f"l{j}"],
                 lambda a, r=r: _to_tensor(np.asarray(a)[r], device))
            for si, j, r in layer_index(cfg)]


def from_jax_params(params_np: Dict[str, Any], cfg: ArchConfig,
                    device="cuda") -> Dict[str, Any]:
    """The reference's ``init_params(cfg, key)`` tree (leaves as numpy) →
    the port's params on ``device`` (raises if CUDA is asked for and
    missing)."""
    device = resolve_device(device)
    out: Dict[str, Any] = {k: _map(v, lambda a: _to_tensor(a, device))
                           for k, v in params_np.items() if k != "segments"}
    out["layers"] = unstack_layers(params_np["segments"], cfg, device)
    return out

