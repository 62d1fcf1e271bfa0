"""Qwen2.5-3B [hf:Qwen/Qwen2.5-3B]. GQA kv=2, QKV bias, tied embeddings."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b",
    family="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    d_ff=11_008,
    vocab_size=151_936,
    head_dim=128,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    max_seq=32_768,
    sub_quadratic=False,
    source="[hf:Qwen/Qwen2.5-3B]",
)
