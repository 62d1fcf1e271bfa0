"""Granite-34B-Code [arXiv:2405.04324; hf]. Deep (88L) llama-style MQA."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,            # MQA
    d_ff=24_576,
    vocab_size=49_152,
    head_dim=128,
    mlp="gelu",
    rope_theta=10_000.0,
    max_seq=8_192,
    sub_quadratic=False,
    source="[arXiv:2405.04324; hf:ibm-granite/granite-34b-code-base]",
)
