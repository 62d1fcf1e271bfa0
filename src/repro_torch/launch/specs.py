"""Shape-only stand-ins for every step input (port of
``repro/launch/specs.py``): ``torch.empty(shape, dtype=..., device="meta")``
where the reference has ``jax.ShapeDtypeStruct``, so a step can be traced
at production shapes with no storage.

``input_specs(cfg, shape)`` returns the inputs of the step that shape
exercises:

  * train_*    → train_step(state, batch)
  * prefill_*  → prefill_step(params, tokens, cache[, frontend])
  * decode_* / long_* → serve_step(params, token, cache, offset)
    (one new token against a KV/state cache of seq_len)

Modality frontends are stubs, as the reference's: paligemma gets 256
precomputed SigLIP patch embeddings (1152-d), musicgen a 64-token
conditioning prefix (768-d), ``[B, frontend_tokens, frontend_dim]`` bf16.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import sharding as SH
from repro_torch.models import transformer as T

META = torch.device("meta")


def sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def batch_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": sds((B, S), torch.int32),
             "labels": sds((B, S), torch.int32)}
    if cfg.frontend:
        batch["frontend"] = sds((B, cfg.frontend_tokens, cfg.frontend_dim),
                                torch.bfloat16)
    return batch


def params_specs(cfg: ArchConfig):
    return T.init_params(cfg, device=META)


def cache_specs_abstract(cfg: ArchConfig, batch: int, max_len: int):
    return SH.cache_shapes(cfg, batch, max_len)


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Abstract inputs keyed by step-function argument name."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"batch": batch_specs(cfg, shape)}
    if shape.kind == "prefill":
        out = {"tokens": sds((B, S), torch.int32),
               "cache": cache_specs_abstract(cfg, B, S + cfg.frontend_tokens)}
        if cfg.frontend:
            out["frontend"] = sds((B, cfg.frontend_tokens, cfg.frontend_dim),
                                  torch.bfloat16)
        return out
    if shape.kind == "decode":
        return {"token": sds((B, 1), torch.int32),
                "cache": cache_specs_abstract(cfg, B, S),
                "offset": sds((), torch.int32)}
    raise ValueError(shape.kind)
