"""MusicGen-medium [arXiv:2306.05284; hf]. Decoder-only over EnCodec tokens
(vocab 2048); conditioning frontend STUB provides a 64-token prefix of
T5-width embeddings (the paper uses cross-attention; the conditioning enters
as a projected prefix, as in the reference). Sinusoidal positions, MHA."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,           # full MHA
    d_ff=6144,
    vocab_size=2048,
    head_dim=64,
    mlp="gelu",
    pos_embed="sinusoidal",
    frontend="audio_stub",
    frontend_tokens=64,
    frontend_dim=768,          # T5-base conditioning width
    max_seq=32_768,
    sub_quadratic=False,
    source="[arXiv:2306.05284; hf:facebook/musicgen-medium]",
)
