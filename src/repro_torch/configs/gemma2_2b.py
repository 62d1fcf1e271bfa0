"""Gemma-2 2B [arXiv:2408.00118; hf]. Local(4096-window)/global alternating,
logit softcaps, sandwich norms, GeGLU, tied + scaled embeddings."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    d_ff=9216,
    vocab_size=256_000,
    head_dim=256,
    mlp="geglu",
    norm_style="sandwich",
    embed_scale=True,
    tie_embeddings=True,
    logit_softcap=30.0,
    attn_softcap=50.0,
    sliding_window=4096,
    layer_pattern=("local", "global") * 13,
    rope_theta=10_000.0,
    max_seq=8_192,
    sub_quadratic=False,
    source="[arXiv:2408.00118; hf:google/gemma-2-2b]",
)
