"""Meshes of virtual devices on one torch device (port of
``repro/launch/mesh.py``).

The reference's mesh is a grid of jax devices; GSPMD compiles one program
whose shards run on them.  The port runs on one card, and NCCL will not
place two ranks on one card, so a port mesh is a grid of VIRTUAL devices
that all live on one torch device:

  * ``axis_names`` and ``shape`` (an ordered name → size mapping, as jax's
    ``mesh.shape``) are the reference's, so every ``PartitionSpec`` the
    sharding policy derives from them is the reference's exactly;
  * ``devices`` holds the virtual device ids in the reference's row-major
    order (a numpy array of the mesh's shape), so a spec's per-device
    blocks (``models.sharding.shard``) are the blocks jax would place on
    each device;
  * ``device`` is the torch device every tensor lives on (None for an
    abstract mesh, which only prices specs; ``meta`` for the dry run's,
    whose steps run on shapes only).

GSPMD's contract is that the sharded program computes what the unsharded
one computes.  On one card that program is the unsharded one, on the
whole global batch, with no communication: one card has nothing to
communicate.  A torch.distributed backend over meshes of real cards is a
feature the reference lacks; it waits for more than one card.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch


class Mesh:
    """A grid of virtual devices over one torch device (None: abstract)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices=None, device: Optional[torch.device] = None):
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} needs one size per axis "
                             f"name {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"duplicate mesh axis names {axis_names}")
        n = math.prod(shape)
        ids = np.arange(n) if devices is None else np.asarray(devices)
        if ids.size != n or len(set(ids.reshape(-1).tolist())) != n:
            raise ValueError(f"mesh {shape} needs {n} distinct device ids, "
                             f"got {ids.reshape(-1).tolist()}")
        self.axis_names = axis_names
        self.shape = OrderedDict(zip(axis_names, shape))
        self.devices = ids.reshape(shape)
        self.device = device

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self, device_id: int) -> tuple:
        """The mesh coordinates of virtual device ``device_id``."""
        where = np.argwhere(self.devices == device_id)
        if len(where) != 1:
            raise ValueError(f"device {device_id} is not in the mesh")
        return tuple(int(c) for c in where[0])

    def __repr__(self) -> str:
        where = "abstract" if self.device is None else str(self.device)
        return f"Mesh({describe(self)}, {where})"


def make_mesh(shape, axes, devices=None, device="cuda") -> Mesh:
    """A mesh of ``shape`` over ``axes`` on ``device`` (default ``cuda``;
    raises if CUDA is asked for and missing).  ``devices`` orders the
    virtual ids (default ``0..n-1`` row-major, as the reference's)."""
    from repro_torch.device import resolve_device
    return Mesh(shape, axes, devices=devices, device=resolve_device(device))


def abstract_mesh(shape, axes) -> Mesh:
    """A mesh with no torch device, for specs only (the reference's
    ``compat.abstract_mesh``)."""
    return Mesh(shape, axes)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The reference's v5e pod meshes: 16×16 = 256 chips ("data",
    "model"); the multi-pod variant stacks 2 pods on a leading "pod" axis
    (512 chips).  Abstract by default: specs need only the sizes.
    ``device="meta"`` puts it on the ``meta`` device, where a step builder
    takes it and a step runs on shapes only (the dry run,
    ``launch/dryrun.py``); one card holds no other such mesh."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if device is None:
        return abstract_mesh(shape, axes)
    if torch.device(device).type != "meta":
        raise ValueError(f"a production mesh is abstract or on meta, not "
                         f"{device!r}")
    return Mesh(shape, axes, device=torch.device("meta"))


def describe(mesh) -> str:
    return " × ".join(f"{a}={mesh.shape[a]}" for a in mesh.axis_names)
