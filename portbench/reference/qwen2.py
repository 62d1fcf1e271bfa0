"""The Qwen2 family (``model_type: qwen2``): a dense decoder with GQA,
biases on q, k and v, rope, RMSNorm, SwiGLU and, where the configuration
says so, the embedding tied to the head.  The model is ``lm``'s; this
module reads the configuration file's keys."""

from portbench.reference.lm import (ModelSpec, loss, param_leaves,  # noqa: F401
                                    segments, train_flops)


def spec(cfg: dict) -> ModelSpec:
    """The ``ModelSpec`` of a configuration file in the source's keys."""
    heads = cfg["num_attention_heads"]
    return ModelSpec(
        name=cfg["name"], n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], n_heads=heads,
        n_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg["hidden_size"] // heads,
        d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
        qkv_bias=True, tied=cfg["tie_word_embeddings"],
        rope_theta=float(cfg["rope_theta"]), norm_eps=cfg["rms_norm_eps"],
        param_dtype=cfg["param_dtype"])


def small(cfg: dict) -> dict:
    """The configuration at a size a CPU test holds: 2 layers of width 64,
    4 heads over 2 KV heads, FFN 128, a vocabulary of 256."""
    return dict(cfg, hidden_size=64, num_attention_heads=4,
                num_key_value_heads=2, intermediate_size=128,
                vocab_size=256, num_hidden_layers=2)
