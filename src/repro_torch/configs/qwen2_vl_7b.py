"""Qwen2-VL-7B [arXiv:2409.12191]: M-RoPE backbone; vision frontend stubbed
(input_specs provides patch embeddings)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab_size=152064, qkv_bias=True, rope_theta=1e6,
    mrope_sections=(16, 24, 24),
)
