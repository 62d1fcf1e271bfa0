"""Device resolution for the port's entry points.

There is no silent fallback: a caller that asks for CUDA on a machine
without it gets an error, never a run on the CPU that looks like a run on
the card.  Kernel dispatch follows the tensor's own device (see
``kernels/paged_attention/ops.py``), so this is the one place that decides
where a run lives.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``"cuda"``/``"cuda:N"``/``"cpu"`` (or a ``torch.device``) → a checked
    ``torch.device``.  Raises ``RuntimeError`` when CUDA is asked for and
    unavailable, ``ValueError`` for any other device type."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but CUDA is not available "
                "(pass --device cpu / device='cpu' to run on the CPU)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {str(device)!r} (cuda | cpu)")
