"""Architecture registry: ``--arch <id>`` → ArchConfig, plus param counting.

Mirrors ``repro/models/registry.py``.  The port serves one architecture so
far (slice 1: gemma2-2b); the other nine ids of the reference are known
here and raise ``NotImplementedError`` until the slice that ports their
layers (MLA, MoE, SSM, frontends) lands.
"""

from __future__ import annotations

import importlib
from typing import List

import torch

from repro_torch.configs.base import ArchConfig

ARCH_IDS: List[str] = [
    "deepseek-v3-671b",
    "qwen3-moe-235b-a22b",
    "qwen2.5-3b",
    "granite-34b",
    "phi4-mini-3.8b",
    "gemma2-2b",
    "paligemma-3b",
    "musicgen-medium",
    "xlstm-1.3b",
    "jamba-v0.1-52b",
]

# ids whose config (and layers) the port carries today
PORTED_IDS: List[str] = ["gemma2-2b"]


def _module_name(arch_id: str) -> str:
    return "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_")


def get_config(name: str) -> ArchConfig:
    smoke = name.endswith("-smoke")
    base = name[:-len("-smoke")] if smoke else name
    if base not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    if base not in PORTED_IDS:
        raise NotImplementedError(
            f"arch {base!r} is not ported yet (port slice 3: the remaining "
            f"architectures); ported: {PORTED_IDS}")
    cfg = importlib.import_module(_module_name(base)).CONFIG
    return cfg.reduced() if smoke else cfg


# ---------------------------------------------------------------------------
# parameter counting (memory budgets)
# ---------------------------------------------------------------------------


def param_shapes(cfg: ArchConfig):
    """The port's parameter tree on the ``meta`` device: shapes and dtypes,
    no storage."""
    from repro_torch.models.transformer import init_params
    return init_params(cfg, device="meta")


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def count_params(cfg: ArchConfig, active_only: bool = False) -> int:
    """Total parameter count from the port's own parameter shapes.  Dense
    architectures only (every parameter is active per token); MoE counting
    comes with the MoE layers."""
    if cfg.moe is not None:
        raise NotImplementedError(
            "MoE parameter counting comes with the MoE layers (port slice 3)")
    return sum(leaf.numel() for leaf in _leaves(param_shapes(cfg)))

