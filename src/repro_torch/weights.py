"""Carry the reference's parameters (and paged caches) across to the port.

``from_jax_params`` converts a parameter tree; ``unstack_layers`` converts
any per-segment stacked tree, such as a paged cache; ``reference_leaves``
goes the other way, listing the port's tensors in the reference's leaf
order and stacked shapes (the flat layout of the BSP superstep).

The reference stacks each segment's unit as ``[reps, ...]`` leaves
(``segments[s][f"l{j}"]``) and scans them; the port keeps one dict per
layer.  Layer ``i`` of a segment whose unit has ``u`` kinds is unit entry
``j = i % u`` at repeat ``r = i // u`` — for gemma2 (``(("local",
"global"), 13)``) layer ``i`` is ``segments[0][f"l{i % 2}"][...][i // 2]``.
Paged caches are stacked the same way, so the same mapping serves both
(attention {"k", "v"} pools and MLA {"c_kv", "k_rope"} pools alike).
Leaves outside ``segments`` carry over as they are, the MTP list of
DeepSeek-V3 included; the MoE router stays f32.

The input is the reference's tree with every leaf converted by
``np.asarray`` (numpy arrays; no JAX object crosses over).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

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


@dataclass(frozen=True)
class StackedLeaf:
    """One leaf of the reference's parameter tree, in the port's layout:
    ``parts`` are the port's tensors whose flattened concatenation is the
    reference's flattened leaf of shape ``shape``."""

    path: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    parts: Tuple[torch.Tensor, ...]


def _sorted_items(tree, path: str):
    """(path, subtree-or-leaf) pairs of a nested dict/list in
    ``jax.tree.leaves`` order: dict keys sorted as strings, lists in
    order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _sorted_items(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _sorted_items(v, f"{path}/{i}")
    else:
        yield path, tree


def reference_leaves(params: Dict[str, Any], cfg: ArchConfig
                     ) -> List[StackedLeaf]:
    """The port's params as the reference's ``jax.tree.leaves(params)``:
    same order, same (layer-stacked) shapes.

    Top-level keys are sorted (``embed``, ``final_norm``, ``segments``);
    each ``segments[s]["l{j}"]`` leaf is stacked ``[reps, ...]`` over the
    segment's repeats, so its parts are the matching tensor of layers
    ``(s, j, r)`` for r = 0..reps-1.  The engine's flat layout, buckets,
    ZeRO shards and layout tag all follow this order."""
    tree: Dict[str, Any] = {k: v for k, v in params.items() if k != "layers"}
    groups: Dict[tuple, List[int]] = {}
    for i, (si, j, _r) in enumerate(layer_index(cfg)):
        groups.setdefault((si, j), []).append(i)
    tree["segments"] = [
        {f"l{j}": [params["layers"][i] for i in groups[(si, j)]]
         for j in range(len(unit))}
        for si, (unit, _reps) in enumerate(cfg.segments())]
    out: List[StackedLeaf] = []
    for key in sorted(tree):
        if key != "segments":
            for path, t in _sorted_items(tree[key], key):
                out.append(StackedLeaf(path, tuple(t.shape), t.dtype, (t,)))
            continue
        for si, seg in enumerate(tree["segments"]):
            for name in sorted(seg):
                layers = seg[name]
                for sub, first in _sorted_items(layers[0], ""):
                    parts = tuple(_lookup(layer, sub) for layer in layers)
                    out.append(StackedLeaf(
                        f"segments/{si}/{name}{sub}",
                        (len(parts),) + tuple(first.shape), first.dtype,
                        parts))
    return out


def _lookup(tree, path: str):
    for k in path.strip("/").split("/"):
        tree = tree[k]
    return tree


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

