"""Plain PyTorch version of the codec family's kernel: error feedback (EF)
in place on one bucket of the BSP sync.

The CPU path of ``ops.error_feedback_`` runs it, and ``chip_smoke.py`` and
the card's tests hold ``csrc/error_feedback.cu`` against it on the card,
bit for bit.  It is the train step's EF as it ran before the kernel, four
lines: ``optim/compression.quantization_error`` computes the codec's
residual, and the in-place updates keep the bucket and the residual in
their own storage.
"""

from __future__ import annotations

import torch

from repro_torch.optim.compression import Codec, quantization_error


def error_feedback_ref_(g: torch.Tensor, res: torch.Tensor,
                        codec: Codec) -> None:
    """EF-SGD in place: ``g += res``; ``res = quantization_error(g)``;
    ``g -= res``.  g is the corrected payload the wire carries; res the
    residual the next step adds."""
    g.add_(res)
    new_res = quantization_error(g, codec)
    res.copy_(new_res)
    g.sub_(new_res)
