"""Phi-4-mini 3.8B [arXiv:2412.08905; hf]. RoPE SwiGLU GQA, 200k vocab."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi4-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=200_064,
    head_dim=128,
    tie_embeddings=True,
    rope_theta=10_000.0,
    max_seq=131_072,
    sub_quadratic=False,
    source="[arXiv:2412.08905; hf:microsoft/Phi-4-mini-instruct]",
)
