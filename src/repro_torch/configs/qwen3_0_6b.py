"""Qwen3 0.6B [hf:Qwen/Qwen3-0.6B; assignment spec]: qk_norm, GQA."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, d_head=128,
    d_ff=3072, vocab_size=151936, qk_norm=True, rope_theta=1e6,
    tie_embeddings=True,
)
