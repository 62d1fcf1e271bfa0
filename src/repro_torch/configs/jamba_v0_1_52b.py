"""Jamba-v0.1 52B [arXiv:2403.19887; hf]. Mamba+attention 1:7 interleave
(attn at layer i%8==4), MoE 16e top-2 every other layer; hybrid → runs
long_500k. No explicit positional embeddings (Mamba supplies order)."""
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig

_UNIT = ("mamba", "mamba_moe", "mamba", "mamba_moe",
         "attn", "mamba_moe", "mamba", "mamba_moe")

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14_336,
    vocab_size=65_536,
    head_dim=128,
    pos_embed="none",
    layer_pattern=_UNIT * 4,
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=14_336, num_shared=0,
                  router="softmax", norm_topk=True, capacity_factor=1.25),
    ssm=SSMConfig(kind="mamba", d_state=16, d_conv=4, expand=2),
    max_seq=524_288,
    sub_quadratic=True,
    source="[arXiv:2403.19887; hf:ai21labs/Jamba-v0.1]",
)
