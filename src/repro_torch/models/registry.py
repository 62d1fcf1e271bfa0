"""Architecture registry: ``--arch <id>`` → ArchConfig, plus param counting.

Mirrors ``repro/models/registry.py``.  The port carries gemma2-2b (slices
1 and 2), deepseek-v3-671b (slice 3: MLA, MoE, MTP params), the four
attention configs of slice 9 (qwen2.5-3b, phi4-mini-3.8b, granite-34b,
qwen3-moe-235b-a22b) and the recurrent and hybrid configs of slice 10
(xlstm-1.3b, jamba-v0.1-52b; served only); the two frontend ids of the
reference are known here and raise ``NotImplementedError`` until the
slice that ports frontends lands.
"""

from __future__ import annotations

import importlib
import math
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
PORTED_IDS: List[str] = ["gemma2-2b", "deepseek-v3-671b", "qwen2.5-3b",
                         "phi4-mini-3.8b", "granite-34b",
                         "qwen3-moe-235b-a22b", "xlstm-1.3b",
                         "jamba-v0.1-52b"]


def _module_name(arch_id: str) -> str:
    return "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_")


def get_config(name: str) -> ArchConfig:
    smoke = name.endswith("-smoke")
    base = name[:-len("-smoke")] if smoke else name
    if base not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    if base not in PORTED_IDS:
        raise NotImplementedError(
            f"arch {base!r} is not ported yet (a later slice of the port: "
            f"the frontend architectures); ported: {PORTED_IDS}")
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
    """Total (or per-token-active) parameter count, from the port's own
    parameter shapes on the ``meta`` device (no storage).

    The leaves are walked as the reference's ``jax.tree.leaves`` sees them
    (``weights.reference_leaves``: layer-stacked ``[reps, ...]`` segment
    leaves, the MTP list), so the counts equal the reference's.  Active
    MoE params: routed expert weights count at top_k/num_experts;
    everything else (router, shared experts, attention, norms) is always
    on."""
    from repro_torch.weights import reference_leaves
    total = 0
    for leaf in reference_leaves(param_shapes(cfg), cfg):
        n = math.prod(leaf.shape)
        if active_only and cfg.moe is not None and _is_routed_expert(
                leaf.path, leaf.shape, cfg):
            n = int(n * cfg.moe.top_k / cfg.moe.num_experts)
        total += n
    return total


def _is_routed_expert(path: str, shape, cfg: ArchConfig) -> bool:
    keys = path.split("/")
    if "ffn" not in keys or "shared" in keys or "router" in keys:
        return False
    # routed expert tensors carry the expert dim: [..., E, D, F]-shaped
    return any(s == cfg.moe.num_experts for s in shape)


def embedding_params(cfg: ArchConfig) -> int:
    n = cfg.vocab_size * cfg.d_model
    if not cfg.tie_embeddings:
        n *= 2
    return n


def non_embedding_params(cfg: ArchConfig, active_only=False) -> int:
    return count_params(cfg, active_only) - embedding_params(cfg)
