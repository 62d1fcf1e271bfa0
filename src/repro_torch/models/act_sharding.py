"""Activation sharding constraints (port of
``repro/models/act_sharding.py``).

The reference pins GSPMD's activation layouts with
``with_sharding_constraint`` at fixed sites of the model:

    hidden  [B, T, D]      → P(dp, None, None)
    logits  [B, T, V]      → P(dp, None, "model")
    moe_buf [B/G, E, C, D] → P(dp, "model", None, None)

The policy is process-global and set by the step builders
(``runtime/trainer``); when unset every hook is a no-op.  The port calls
the hooks at the same sites.  With a policy set, a hook computes the
reference's fixed spec (``fixed_spec``: axes missing from the mesh or not
dividing their dimension dropped) and keeps it in ``LAST_SPEC``, then
returns ``x`` unchanged: a mesh is virtual devices on one torch device
(``launch/mesh.py``), so there is no layout to enforce.  Without a
policy each hook costs one global check.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from repro_torch.models.sharding import P

_POLICY: Optional[Tuple[object, Tuple[str, ...]]] = None

# hillclimb lever: additionally shard the sequence dim of hidden states over
# "model" (sequence parallelism for norms/pointwise)
SEQ_SHARD = False

# the fixed spec of the last hook called under a policy
LAST_SPEC: Optional[P] = None


def set_policy(mesh, dp_axes: Tuple[str, ...]) -> None:
    global _POLICY
    _POLICY = (mesh, tuple(dp_axes))


def clear_policy() -> None:
    global _POLICY
    _POLICY = None


def fixed_spec(shape: Sequence[int], spec, mesh) -> P:
    """The reference's constraint for a ``shape`` array asked to take
    ``spec`` (one entry per leading dimension) on ``mesh``: each entry's
    axes that are missing from the mesh dropped, and the entry dropped
    unless the rest divide its dimension."""
    fixed = []
    for dim, ax in zip(shape, spec):
        if ax is None:
            fixed.append(None)
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        axes = tuple(a for a in axes if a in mesh.shape)
        size = 1
        for a in axes:
            size *= mesh.shape[a]
        fixed.append(axes if (axes and dim % size == 0) else None)
    return P(*fixed)


def _constrain(x, *spec):
    global LAST_SPEC
    if _POLICY is None:
        return x
    LAST_SPEC = fixed_spec(tuple(x.shape), spec, _POLICY[0])
    return x


def _dp():
    return _POLICY[1] if _POLICY else ("data",)


def hidden(x):
    """[B, T, D] (or [B, T, ...]): batch over the DP axes (+ optional
    sequence-parallel T over "model")."""
    t_axis = "model" if SEQ_SHARD else None
    return _constrain(x, _dp(), t_axis, *([None] * (x.ndim - 2)))


def logits(x):
    """[B, T, V]: batch over DP, vocab over model."""
    return _constrain(x, _dp(), None, "model")


SERVE_EP = False   # set by serving step builders: experts over ALL axes


def moe_buf(x):
    """[G, E, C, D]: groups over DP, experts over model (EP); in serving,
    experts span every axis when the expert count covers it, else
    E-over-model."""
    if SERVE_EP and _POLICY is not None:
        mesh, dp = _POLICY
        ep = ("model",) + tuple(dp)
        size = 1
        for a in ep:
            size *= mesh.shape.get(a, 1)
        if x.shape[1] % size == 0:
            return _constrain(x, None, ep, None, None)
    return _constrain(x, _dp(), "model", None, None)


def scores_sshard(x):
    """[B, H, T, S] decode scores: keep S over "model" (flash-decode
    layout; heads replicate — tiny for T==1)."""
    return _constrain(x, _dp(), None, None, "model")


def kv(x):
    """[B, S, H, D] expanded keys/values: batch over DP, sequence over
    "model".  The reference defines it for the MLA path; no model site
    calls it."""
    return _constrain(x, _dp(), "model", *([None] * (x.ndim - 2)))
