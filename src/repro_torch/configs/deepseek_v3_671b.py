"""DeepSeek-V3 671B [arXiv:2412.19437]: MLA, 1 shared + 256 routed top-8, MTP."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=18432,  # first 3 dense layers
    vocab_size=129280, rope_theta=1e4,
    n_experts=256, n_experts_per_tok=8, moe_d_ff=2048,
    n_shared_experts=1, shared_d_ff=2048, first_dense_layers=3,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    mtp=True,
)
