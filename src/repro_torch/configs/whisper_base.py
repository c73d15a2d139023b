"""Whisper-base [arXiv:2212.04356]: enc-dec; conv frontend stubbed (frame
embeddings provided by input_specs)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab_size=51865,
    is_encoder_decoder=True, n_encoder_layers=6, frontend="audio_frames",
    tie_embeddings=True,
)
