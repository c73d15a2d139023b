"""Zamba2-2.7B [arXiv:2411.15242]: Mamba2 backbone + shared attention block."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_head=80,
    d_ff=10240, vocab_size=32000, rope_theta=1e4,
    ssm_state=64, ssm_head_dim=64, attn_every=6,
    subquadratic=True,
)
