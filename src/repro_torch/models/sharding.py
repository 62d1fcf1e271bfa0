"""Parameter / batch / cache sharding policy (port of
``repro/models/sharding.py``).

Mesh axes: ``("data","model")`` single-pod, ``("pod","data","model")``
multi-pod.  Policy (MaxText-style FSDP × TP), the reference's rule for
rule:

  * FSDP axes = ("pod","data"): parameters + optimizer moments sharded on
    the d_model-ish dimension (ZeRO-3).
  * TP axis = "model": attention heads / MoE experts / d_ff / vocab.
  * Guards: a dim only gets an axis if divisible by the axis product AND,
    for head-structured projections, if the head count itself divides the
    axis — otherwise that axis is dropped (e.g. gemma2's 8 heads on a
    16-way model axis: attention stays fsdp-only).
  * Decode caches shard batch over FSDP axes and sequence over "model".

A spec here is the reference's ``PartitionSpec`` exactly: ``P`` is a
tuple that normalises its entries as jax's does (a 1-tuple becomes its
name, an empty tuple None), so it compares equal to the reference's.
The port's params are one dict per layer; ``param_specs`` walks them in
the reference's leaf paths and layer-stacked shapes
(``weights.reference_leaves``), so a stacked leaf's spec keeps the
reference's leading None; ``port_param_specs`` gives each of the port's
tensors its spec (the same spec without that None).

A mesh is virtual devices on one torch device (``launch/mesh.py``), so a
spec does not move data.  ``shard`` is its executable meaning: the block
of a tensor each virtual device holds (replicated axes repeated), which
is the block jax's ``device_put`` places on that device; ``unshard`` is
its inverse.  ``check_spec`` raises where ``device_put`` raises.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Sequence, Tuple

import torch

from repro_torch.configs.base import ArchConfig


def _norm(entry):
    if entry is None or isinstance(entry, str):
        return entry
    entry = tuple(entry)
    if not entry:
        return None
    return entry[0] if len(entry) == 1 else entry


class PartitionSpec(tuple):
    """The reference's ``PartitionSpec``: one entry per dimension (None,
    an axis name or a tuple of axis names), normalised as jax's."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(_norm(p) for p in parts))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "PartitionSpec" + (tuple.__repr__(self) if len(self) != 1
                                  else f"({self[0]!r},)")


P = PartitionSpec


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""

    mesh: Any
    spec: PartitionSpec


def fsdp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    axes = (axes,) if isinstance(axes, str) else axes
    return math.prod(mesh.shape[a] for a in axes)


def _fits(dim: int, mesh, axes) -> bool:
    return dim % axis_size(mesh, axes) == 0


def _keys(path: str) -> list:
    """A ``weights.reference_leaves`` path as the reference's path keys
    (list indices as ints)."""
    return [int(k) if k.isdigit() else k for k in path.split("/") if k]


# name of the projection component (parent of the "w"/"b" leaf)
_COL_PARALLEL = {"wq", "w_gate", "w_up", "up_proj", "in_proj", "q_up",
                 "kv_up", "ffn_up", "w_if"}          # [D_in, D_out·TP]
_ROW_PARALLEL = {"wo", "w_down", "out_proj", "down_proj", "ffn_down",
                 "dt_proj"}                          # [D_in·TP, D_out]
_KV_PROJ = {"wk", "wv"}
_REPLICATED = {"q_norm", "k_norm", "norm", "norm1", "norm2", "post1", "post2",
               "out_norm", "group_norm", "final_norm", "kv_norm",
               "frontend_proj", "proj", "skip", "r_gates"}


def _leaf_spec(cfg: ArchConfig, keys: list, shape: Tuple[int, ...],
               mesh, mode: str = "train") -> P:
    """mode="train": FSDP×TP (ZeRO-3: per-layer weight gathers amortize over
    fwd+bwd).  mode="serve": weights must not move per token — dense weights
    TP-only (replicated over the data axes), MoE experts sharded over ALL
    axes (full EP: tokens travel, weights stay)."""
    fsdp = fsdp_axes(mesh) if mode == "train" else ()
    ep_axes = ("model",) + fsdp_axes(mesh) if mode == "serve" else ("model",)
    has_model = "model" in mesh.shape
    stacked = "segments" in keys          # the stacked leading repeat dim
    nd = len(shape)
    lead = (None,) if stacked else ()
    body = shape[1:] if stacked else shape

    def spec(*axes):
        axes = tuple(a if (a and _fits(body[i], mesh, a)) else None
                     for i, a in enumerate(axes))
        return P(*(lead + axes))

    # ---- top-level tensors -------------------------------------------------
    if keys[:1] == ["embed"]:
        return spec("model", fsdp)
    if "head" in keys:
        return spec(fsdp, "model")
    if keys and keys[0] == "mtp" and "block" not in keys:
        return P(*((None,) * nd))

    name = next((k for k in reversed(keys)
                 if isinstance(k, str) and k not in ("w", "b")), "")

    if name in _REPLICATED or not has_model and not fsdp:
        return P(*((None,) * nd))

    # ---- MoE expert tensors [E, D, F] / [E, F, D]: EP over "model"
    # (train) or over every axis (serve) ----
    if name in ("w_gate", "w_up", "w_down") and len(body) == 3 \
            and cfg.moe and body[0] == cfg.moe.num_experts:
        if mode == "serve":
            if body[0] % axis_size(mesh, ep_axes) == 0:
                return spec(ep_axes, None, None)   # full EP: 1 expert/chip
            # E doesn't cover every axis: E over "model" + intra-expert TP
            # over the data axes
            ftp = fsdp_axes(mesh)
            if name == "w_down":
                return spec("model", ftp, None)
            return spec("model", None, ftp)
        if name == "w_down":
            return spec("model", None, fsdp)
        return spec("model", fsdp, None)

    leaf = keys[-1] if keys else ""
    if leaf == "b":                      # bias of a projection
        if name in _COL_PARALLEL and _head_ok(cfg, name, mesh):
            return spec("model")
        return P(*((None,) * nd))

    if len(body) == 1:                   # 1-D vectors (A, D, conv_b, scale)
        if name in ("A_log", "D", "conv_b") or leaf in ("D",):
            return spec("model") if len(body) == 1 else P(None)
        return P(*((None,) * nd))

    if name == "conv_w":                 # [K, C]
        return spec(None, "model")
    if name in ("A_log",):               # [d_in, N]
        return spec("model", None)
    if name == "x_proj":                 # [d_in, dt+2N]: row-parallel-ish
        return spec("model", None)
    if name in ("wq", "wk", "wv") and len(body) == 3:
        return P(*((None,) * nd))        # xLSTM headwise cells: replicate

    if name in _COL_PARALLEL:
        model = "model" if _head_ok(cfg, name, mesh) else None
        return spec(fsdp, model)
    if name in _KV_PROJ:
        model = "model" if cfg.num_kv_heads % axis_size(mesh, "model") == 0 \
            else None
        return spec(fsdp, model)
    if name in _ROW_PARALLEL:
        model = "model" if _head_ok(cfg, name, mesh) else None
        return spec(model, fsdp)
    if name in ("router", "q_down", "kv_down"):
        return spec(fsdp, None)
    # default: replicate
    return P(*((None,) * nd))


def _head_ok(cfg: ArchConfig, name: str, mesh) -> bool:
    """Head-structured projections need heads % TP == 0 to stay
    head-aligned."""
    tp = axis_size(mesh, "model")
    if name in ("wq", "wo"):
        return cfg.num_heads % tp == 0
    return True


def param_specs(cfg: ArchConfig, params_shape, mesh,
                mode: str = "train") -> Dict[str, P]:
    """``{reference leaf path: spec}`` in the reference's leaf order, from
    the port's params (or their ``meta`` shapes; None: the registry's
    ``param_shapes``).  The values, in order, are the reference's
    ``jax.tree.leaves`` of its spec tree."""
    from repro_torch.weights import reference_leaves
    if params_shape is None:
        from repro_torch.models.registry import param_shapes
        params_shape = param_shapes(cfg)
    return {leaf.path: _leaf_spec(cfg, _keys(leaf.path), leaf.shape, mesh,
                                  mode)
            for leaf in reference_leaves(params_shape, cfg)}


def port_spec(path: str, spec: P) -> P:
    """The spec of one of the port's tensors of reference leaf ``path``: a
    layer-stacked leaf's spec without its leading (repeat-axis) None."""
    return P(*spec[1:]) if path.startswith("segments/") else spec


def port_param_specs(cfg: ArchConfig, params, specs: Dict[str, P]):
    """``params``' tree (one dict per layer) with each tensor replaced by
    its spec (``port_spec`` of ``specs``, a ``param_specs`` result)."""
    from repro_torch.weights import reference_leaves
    by_id = {}
    for leaf in reference_leaves(params, cfg):
        for t in leaf.parts:
            by_id[id(t)] = port_spec(leaf.path, specs[leaf.path])
    return _map(params, lambda t: by_id[id(t)])


# ---------------------------------------------------------------------------
# batch / cache / logits specs
# ---------------------------------------------------------------------------


def batch_spec(mesh) -> Dict[str, P]:
    dp = fsdp_axes(mesh)
    return {"tokens": P(dp, None), "labels": P(dp, None),
            "frontend": P(dp, None, None)}


def cache_leaves(cache, cfg: ArchConfig):
    """A per-layer cache as the reference's layer-stacked cache leaves
    (``weights.StackedLeaf``, paths ``"<segment>/l<j>/<name>"``, shapes
    ``[reps, batch, ...]``), in the reference's leaf order."""
    import dataclasses
    from repro_torch.weights import reference_leaves
    return [dataclasses.replace(leaf, path=leaf.path[len("segments/"):])
            for leaf in reference_leaves({"layers": cache}, cfg)]


def cache_specs(cfg: ArchConfig, cache_shape, mesh) -> Dict[str, P]:
    """Decode caches: batch over FSDP, sequence (or largest state dim) over
    "model" when divisible.  ``{reference leaf path: spec}`` of the port's
    per-layer cache (or its ``meta`` shapes), in the reference's order."""
    dp = fsdp_axes(mesh)

    def leaf(keys, shape):
        name = next((k for k in reversed(keys) if isinstance(k, str)), "")
        nd = len(shape)
        base = [None] * nd        # caches are stacked per repeat: [R, B, ...]
        if nd >= 2 and shape[1] % axis_size(mesh, dp) == 0:
            base[1] = dp            # batch dim (long_500k has batch 1)
        if name in ("k", "v", "c_kv", "k_rope") and nd >= 3 \
                and shape[2] % axis_size(mesh, "model") == 0:
            base[2] = "model"       # sequence dim of KV caches
        elif name in ("h",) and nd >= 3 \
                and shape[2] % axis_size(mesh, "model") == 0:
            base[2] = "model"       # mamba state d_in
        elif name == "conv" and nd >= 4 and \
                shape[-1] % axis_size(mesh, "model") == 0:
            base[-1] = "model"
        return P(*base)

    return {c.path: leaf(_keys(c.path), c.shape)
            for c in cache_leaves(cache_shape, cfg)}


def cache_shapes(cfg: ArchConfig, batch: int, max_len: int,
                 rec_batch=None):
    """``transformer.init_cache(cfg, batch, max_len)`` on the ``meta``
    device: shapes and dtypes, no storage.  With ``rec_batch``,
    ``init_hybrid_cache(cfg, kv_batch=batch, kv_len=max_len,
    rec_batch=rec_batch)``'s instead."""
    from repro_torch.models import transformer as T
    T._check_ported(cfg)
    meta = torch.device("meta")
    return [T._block_cache(cfg, kind, rec_batch, 0, device=meta)
            if rec_batch is not None and kind in T.REC_KINDS else
            T._block_cache(cfg, kind, batch, max_len, device=meta)
            for kind in cfg.layer_pattern]


def _map(tree, fn):
    if isinstance(tree, P) or not isinstance(tree, (dict, list, tuple)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    items = [_map(v, fn) for v in tree]
    if hasattr(tree, "_fields"):              # a NamedTuple
        return type(tree)(*items)
    return type(tree)(items)


def named(mesh, spec_tree):
    """Each spec of ``spec_tree`` on ``mesh``."""
    return _map(spec_tree, lambda s: NamedSharding(mesh, s))


# ---------------------------------------------------------------------------
# a spec's executable meaning on one card
# ---------------------------------------------------------------------------


def _dim_axes(spec, ndim: int):
    parts = list(spec) + [None] * (ndim - len(spec))
    return [() if p is None else (p,) if isinstance(p, str) else tuple(p)
            for p in parts]


def check_spec(shape: Sequence[int], mesh, spec) -> None:
    """Raise where the reference's ``device_put`` of a ``shape`` array onto
    ``NamedSharding(mesh, spec)`` raises: a spec longer than the rank, an
    axis not in the mesh, an axis named twice, a dimension its axes'
    product does not divide."""
    spec = P(*spec)
    if len(spec) > len(shape):
        raise ValueError(f"{spec} has {len(spec)} entries for an array of "
                         f"rank {len(shape)}")
    seen = set()
    for dim, axes in zip(shape, _dim_axes(spec, len(shape))):
        for a in axes:
            if a not in mesh.shape:
                raise ValueError(f"Resource axis: {a} of {spec} is not "
                                 f"found in mesh: {mesh.axis_names}.")
            if a in seen:
                raise ValueError(f"{spec} has duplicate entries for `{a}`")
            seen.add(a)
        if dim % axis_size(mesh, axes):
            raise ValueError(f"{spec} implies that the global size of a "
                             f"dimension should be divisible by "
                             f"{axis_size(mesh, axes)}, but it is {dim}")


def block_index(shape: Sequence[int], mesh, spec, device_id: int):
    """The slices of a ``shape`` array that virtual device ``device_id``
    holds under ``spec``."""
    coords = dict(zip(mesh.axis_names, mesh.coords(device_id)))
    out = []
    for dim, axes in zip(shape, _dim_axes(P(*spec), len(shape))):
        idx = 0
        for a in axes:
            idx = idx * mesh.shape[a] + coords[a]
        local = dim // axis_size(mesh, axes)
        out.append(slice(idx * local, (idx + 1) * local))
    return tuple(out)


def _device_ids(mesh):
    return sorted(int(d) for d in mesh.devices.reshape(-1))


def shard(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    """``[mesh.size, *local]``: each virtual device's block of ``x`` under
    ``spec``, in device-id order (replicated axes repeat the block)."""
    check_spec(tuple(x.shape), mesh, spec)
    return torch.stack([x[block_index(x.shape, mesh, spec, d)]
                        for d in _device_ids(mesh)])


def unshard(blocks: torch.Tensor, mesh, spec) -> torch.Tensor:
    """The inverse of ``shard``: the global tensor from its blocks."""
    local = tuple(blocks.shape[1:])
    shape = tuple(n * axis_size(mesh, axes) for n, axes in
                  zip(local, _dim_axes(P(*spec), len(local))))
    check_spec(shape, mesh, spec)
    out = blocks.new_empty(shape)
    for b, d in zip(blocks, _device_ids(mesh)):
        out[block_index(shape, mesh, spec, d)] = b
    return out
