"""Qwen3-MoE 235B-A22B [hf:Qwen/Qwen3-235B-A22B family; assignment spec]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_head=128,
    d_ff=1536, vocab_size=151936, qk_norm=True, rope_theta=1e6,
    n_experts=128, n_experts_per_tok=8, moe_d_ff=1536,
)
