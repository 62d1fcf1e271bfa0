"""Qwen3-235B-A22B [hf:Qwen/Qwen3-235B-A22B]. 128 experts top-8, GQA kv=4,
head_dim 128 with QK-norm."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    d_ff=1536,                # unused: every layer is MoE (d_expert=1536)
    vocab_size=151_936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    layer_pattern=("attn_moe",) * 94,
    moe=MoEConfig(num_experts=128, top_k=8, d_expert=1536, num_shared=0,
                  router="softmax", norm_topk=True, capacity_factor=1.25),
    max_seq=40_960,
    sub_quadratic=False,
    source="[hf:Qwen/Qwen3-235B-A22B]",
)
