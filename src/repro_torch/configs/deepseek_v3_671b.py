"""DeepSeek-V3 671B [arXiv:2412.19437; hf]. MLA + 1 shared + 256 routed
top-8 (sigmoid aux-loss-free router) + MTP; first 3 layers dense."""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,          # MLA: per-head latents, kv=128 per assignment
    d_ff=18432,                # dense layers (brief's 2048 = routed expert size)
    vocab_size=129280,
    head_dim=128,
    rope_theta=10_000.0,
    layer_pattern=("mla",) * 3 + ("mla_moe",) * 58,
    moe=MoEConfig(num_experts=256, top_k=8, d_expert=2048, num_shared=1,
                  router="sigmoid", norm_topk=True, capacity_factor=1.25),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    mtp_depth=1,
    max_seq=131_072,
    sub_quadratic=False,
    source="[arXiv:2412.19437; hf:deepseek-ai/DeepSeek-V3]",
)
