"""PaliGemma-3B [arXiv:2407.07726; hf]. SigLIP-So400m patch embeddings
(STUB: 256 precomputed 1152-d tokens) + Gemma-2B backbone, prefix-LM."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,            # Gemma-1 MQA
    d_ff=16_384,
    vocab_size=257_216,
    head_dim=256,
    mlp="geglu",
    embed_scale=True,
    tie_embeddings=True,
    rope_theta=10_000.0,
    frontend="vision_stub",
    frontend_tokens=256,       # 224px / 14 patch → 16×16
    frontend_dim=1152,         # SigLIP-So400m width
    prefix_lm=True,
    max_seq=8_192,
    sub_quadratic=False,
    source="[arXiv:2407.07726; hf:google/paligemma-3b-pt-224]",
)
