"""The Qwen2 family (``model_type: qwen2``): a dense decoder with GQA,
biases on q, k and v, rope, RMSNorm, SwiGLU and, where the configuration
says so, the embedding tied to the head."""

from portbench.reference.lm import ModelSpec


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
