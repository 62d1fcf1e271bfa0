"""Wire codecs for gradient-synchronisation payloads (port of
``repro/optim/compression.py``).

  * ``Bf16Codec`` — 2x wire reduction; sums accumulate in f32 after decode.
  * ``Int8Codec`` — 4x; symmetric per-128-block scales.
  * ``error_feedback_step`` — EF-SGD: send quantize(g + residual), keep the
    quantization error for the next step.

Payloads are flat along their LAST axis, so one call encodes every rank's
row of a rank-stacked ``[W, M]`` payload independently (an int8 block never
straddles two ranks); a 1-d ``[M]`` payload gives the reference's shapes
exactly (q ``[M/128, 128]``, scale ``[M/128, 1]``).

Rounding follows the reference as it runs, i.e. under ``jit``, where XLA
rewrites ``max|x| / 127.0`` to ``max|x| * f32(1/127)`` and contracts
``x - f32(q) * scale`` into one fused multiply-add.  The port spells both
out (the multiply by the f32 reciprocal, ``torch.addcmul``), so on the CPU
codes, scales and residuals are equal to the jitted reference bit for bit.
On CUDA ``torch.addcmul`` rounds the product before the difference, so
there the int8 residual is rounded twice and may sit an ulp from the
reference's; codes and scales are still equal (ROADMAP C13).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

_INV_127 = 1.0 / 127.0      # rounded to f32 where it multiplies an f32


class Codec:
    name: str = "identity"
    wire_bytes_per_element: float = 4.0

    def encode(self, x: torch.Tensor):
        return {"x": x}

    def decode(self, wire, shape, dtype) -> torch.Tensor:
        return wire["x"]


@dataclass(frozen=True)
class Bf16Codec(Codec):
    name: str = "bf16"
    wire_bytes_per_element: float = 2.0

    def encode(self, x):
        return {"x": x.to(torch.bfloat16)}

    def decode(self, wire, shape, dtype):
        return wire["x"].to(dtype)


@dataclass(frozen=True)
class Int8Codec(Codec):
    """Symmetric per-block int8: wire = int8 payload + one f32 scale per
    block of ``block`` consecutive elements of the last axis."""
    block: int = 128
    name: str = "int8"

    @property
    def wire_bytes_per_element(self) -> float:
        return 1.0 + 4.0 / self.block

    def _blocks(self, x):
        n = x.shape[-1]
        if n % self.block:
            raise ValueError(f"payload {n} not divisible by block "
                             f"{self.block}")
        return x.reshape(*x.shape[:-1], n // self.block, self.block)

    def encode(self, x):
        xb = self._blocks(x)
        scale = xb.abs().amax(dim=-1, keepdim=True) * _INV_127
        safe = torch.where(scale == 0, torch.ones_like(scale), scale)
        y = xb / safe           # rounded and clamped in place: one temporary
        q = y.round_().clamp_(-127, 127).to(torch.int8)
        return {"q": q, "scale": scale.to(torch.float32)}

    def decode(self, wire, shape, dtype):
        x = wire["q"].to(dtype) * wire["scale"].to(dtype)
        return x.reshape(shape)


def quantization_error(x: torch.Tensor, codec: Codec) -> torch.Tensor:
    """x − dequant(quant(x)): the residual EF carries to the next step.
    For int8 this is ``torch.addcmul(x, f32(q), scale, value=-1)``: on
    the CPU ``fma(-f32(q), scale, x)``, one rounding, as the jitted
    reference computes it; on CUDA the product rounded first, then the
    difference (ROADMAP C13)."""
    wire = codec.encode(x)
    if isinstance(codec, Int8Codec):
        xb = codec._blocks(x)
        return torch.addcmul(xb, wire["q"].to(x.dtype), wire["scale"],
                             value=-1).reshape(x.shape)
    return x - codec.decode(wire, x.shape, x.dtype)


def error_feedback_step(flat_grads: torch.Tensor, residual: torch.Tensor,
                        codec: Codec) -> Tuple[torch.Tensor, torch.Tensor]:
    """EF-SGD: send quantize(g + residual); keep the quantization error.

    Returns (corrected payload to feed the collective, new residual)."""
    corrected = flat_grads + residual
    new_residual = quantization_error(corrected, codec)
    return corrected, new_residual


CODECS = {"none": None, "bf16": Bf16Codec(), "int8": Int8Codec()}
