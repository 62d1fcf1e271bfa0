"""The port's config of a Qwen2 configuration."""

import dataclasses

from portbench.reference.lm import ModelSpec


def program_config(config: dict, spec: ModelSpec):
    """The port's config of the cell: its registry entry with the widths
    and depth of the configuration file; what the file cannot set (biases,
    MLP, positions, tying) has to agree with it."""
    from repro_torch.models.registry import get_config
    base = get_config(config["port_arch"])
    cfg = dataclasses.replace(
        base, num_layers=spec.n_layers, layer_pattern=(),
        d_model=spec.d_model, num_heads=spec.n_heads,
        num_kv_heads=spec.n_kv_heads, head_dim=spec.head_dim,
        d_ff=spec.d_ff, vocab_size=spec.vocab, norm_eps=spec.norm_eps,
        rope_theta=spec.rope_theta, param_dtype=spec.param_dtype)
    want = {"qkv_bias": spec.qkv_bias, "tie_embeddings": spec.tied,
            "mlp": "swiglu", "pos_embed": "rope", "frontend": None,
            "prefix_lm": False}
    have = {k: getattr(cfg, k) for k in want}
    if have != want:
        raise ValueError(f"{config['name']}: the port's {base.name} has "
                         f"{have}, the configuration {want}")
    return cfg
