"""Architecture configuration schema (the port's own copy of
``repro/configs/base.py``: pure data, kept identical field for field).

One ``ArchConfig`` per ported architecture
(``src/repro_torch/configs/<id>.py``), each with a ``reduced()`` smoke-test
variant (same family, tiny dims) that the CPU tests run.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                    # per-expert FFN hidden size
    num_shared: int = 0              # always-on shared experts (DeepSeek)
    capacity_factor: float = 1.25
    router: str = "softmax"          # softmax | sigmoid (DeepSeek v3)
    norm_topk: bool = True           # renormalize selected gates
    router_dtype: str = "float32"


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2/V3)."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba (Jamba) / xLSTM cell parameters."""
    kind: str = "mamba"              # mamba | mlstm | slstm
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None    # default ceil(d_model/16)
    num_heads: int = 4               # xLSTM heads


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // num_heads
    qkv_bias: bool = False
    qk_norm: bool = False            # Qwen3
    mlp: str = "swiglu"              # swiglu | geglu
    pos_embed: str = "rope"          # rope | sinusoidal
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    norm_style: str = "pre"          # pre | sandwich (Gemma-2)
    embed_scale: bool = False        # Gemma: embeddings scaled by sqrt(D)
    tie_embeddings: bool = False
    logit_softcap: Optional[float] = None   # Gemma-2 final softcap
    attn_softcap: Optional[float] = None    # Gemma-2 attention softcap
    sliding_window: Optional[int] = None    # local-attention window
    # per-layer block kinds; scanned in homogeneous segments. kinds:
    #   attn      - dense attention + MLP
    #   attn_moe  - dense attention + MoE
    #   local     - sliding-window attention + MLP
    #   global    - full attention + MLP (used with `local` for Gemma-2)
    #   mla_moe   - MLA attention + MoE (DeepSeek)
    #   mla       - MLA attention + dense MLP
    #   mamba     - Mamba SSM + MLP
    #   mamba_moe - Mamba SSM + MoE
    #   mlstm     - xLSTM mLSTM block (no separate FFN)
    #   slstm     - xLSTM sLSTM block (FFN inside)
    layer_pattern: Tuple[str, ...] = ()
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    mtp_depth: int = 0               # DeepSeek multi-token prediction modules
    mtp_loss_weight: float = 0.3
    frontend: Optional[str] = None   # vision_stub | audio_stub
    frontend_tokens: int = 0         # prefix length provided by the frontend
    frontend_dim: int = 0            # raw frontend embedding dim (projected)
    prefix_lm: bool = False          # bidirectional attention over the prefix
    max_seq: int = 32_768
    sub_quadratic: bool = False      # eligible for long_500k decode
    param_dtype: str = "bfloat16"
    source: str = ""                 # provenance note [arXiv/hf; tier]

    def __post_init__(self):
        if not self.layer_pattern:
            object.__setattr__(self, "layer_pattern",
                               ("attn",) * self.num_layers)
        if len(self.layer_pattern) != self.num_layers:
            raise ValueError(
                f"{self.name}: layer_pattern has {len(self.layer_pattern)} "
                f"entries for {self.num_layers} layers")
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)
        if self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError(f"{self.name}: heads {self.num_heads} not a "
                             f"multiple of kv heads {self.num_kv_heads}")

    # ------------------------------------------------------------------ #

    def segments(self) -> Tuple[Tuple[Tuple[str, ...], int], ...]:
        """Group layer_pattern into repeated homogeneous units for lax.scan.

        Returns ((unit_kinds, repeat), ...) where unit_kinds is the smallest
        repeating unit of a run, e.g. 26×(local,global) → (("local","global"), 13).
        """
        pattern = list(self.layer_pattern)
        # find a small period that tiles the whole pattern
        n = len(pattern)
        for period in range(1, n + 1):
            if n % period == 0 and pattern == pattern[:period] * (n // period):
                unit = tuple(pattern[:period])
                return ((unit, n // period),)
        # fall back: split into maximal uniform runs
        segs = []
        i = 0
        while i < n:
            j = i
            while j < n and pattern[j] == pattern[i]:
                j += 1
            segs.append(((pattern[i],), j - i))
            i = j
        return tuple(segs)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head); used for the
        roofline's MODEL_FLOPS = 6·N·D and the memory budget."""
        from repro_torch.models.registry import count_params
        return count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models.registry import count_params
        return count_params(self, active_only=True)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        scale = lambda v, lo, f: max(lo, v // f)
        pat = self.layer_pattern
        # keep one period of the pattern (≥2 layers when pattern alternates)
        unit, _reps = self.segments()[0]
        keep = len(unit) if len(unit) > 1 else min(2, self.num_layers)
        new_pat = (pat[:keep] if len(set(pat)) == 1
                   else unit)
        if self.name == "deepseek-v3-671b":
            # keep the dense→moe transition: 1 dense + 1 moe layer
            new_pat = ("mla", "mla_moe")
            keep = 2
        kw = dict(
            name=self.name + "-smoke",
            num_layers=len(new_pat),
            layer_pattern=new_pat,
            d_model=128,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            head_dim=32,
            d_ff=0 if self.d_ff == 0 else 256,
            vocab_size=min(self.vocab_size, 512),
            sliding_window=16 if self.sliding_window else None,
            max_seq=128,
            frontend_tokens=min(self.frontend_tokens, 8) if self.frontend_tokens else 0,
            frontend_dim=64 if self.frontend_dim else 0,
            mtp_depth=min(self.mtp_depth, 1),
            param_dtype="float32",
        )
        if self.moe:
            # dropless at smoke scale (capacity ≥ T·k) so decode ≡ forward
            # exactly; production capacity_factor stays GShard-style 1.25
            kw["moe"] = dataclasses.replace(
                self.moe, num_experts=min(self.moe.num_experts, 8),
                top_k=min(self.moe.top_k, 2), d_expert=64,
                capacity_factor=float(min(self.moe.num_experts, 8)))
        if self.mla:
            kw["mla"] = MLAConfig(q_lora_rank=48, kv_lora_rank=32,
                                  qk_nope_head_dim=32, qk_rope_head_dim=16,
                                  v_head_dim=32)
        if self.ssm:
            kw["ssm"] = dataclasses.replace(self.ssm, d_state=8, d_conv=4,
                                            num_heads=2)
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes assigned to every LM-family architecture
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", 4_096, 256, "train"),
    ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    ShapeSpec("decode_32k", 32_768, 128, "decode"),
    ShapeSpec("long_500k", 524_288, 1, "decode"),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}


def cell_applicable(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """long_500k only for sub-quadratic archs (DESIGN.md §5)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: long_500k assigned to SSM/hybrid only"
    return True, ""
