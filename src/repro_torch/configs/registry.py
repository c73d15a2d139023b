"""Architecture registry: ``--arch <id>`` lookup + reduced smoke configs."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

ARCHS: Dict[str, str] = {
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b_a22b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "qwen3-0.6b": "repro_torch.configs.qwen3_0_6b",
    "qwen2.5-32b": "repro_torch.configs.qwen2_5_32b",
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
    "command-r-35b": "repro_torch.configs.command_r_35b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2_7b",
    "qwen2-vl-7b": "repro_torch.configs.qwen2_vl_7b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1_3b",
    "whisper-base": "repro_torch.configs.whisper_base",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(ARCHS[arch]).CONFIG


def smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests (small layers/width/
    experts/vocab, as the assignment prescribes)."""
    cfg = get_config(arch)
    common = dict(
        vocab_size=256,
        d_model=64,
        d_ff=128,
        remat_policy="none",
        dtype="float32",
    )
    if cfg.family in ("dense", "moe", "vlm"):
        upd = dict(
            common,
            n_layers=2,
            n_heads=4,
            n_kv_heads=2,
            d_head=16,
        )
        if cfg.family == "vlm":
            upd["mrope_sections"] = (4, 2, 2)
        if cfg.is_moe:
            upd.update(
                n_experts=8,
                n_experts_per_tok=2,
                moe_d_ff=32,
                first_dense_layers=min(1, cfg.first_dense_layers),
                n_shared_experts=cfg.n_shared_experts,
                shared_d_ff=32 if cfg.n_shared_experts else 0,
            )
        if cfg.use_mla:
            upd.update(
                n_layers=2,
                q_lora_rank=32,
                kv_lora_rank=16,
                qk_nope_head_dim=16,
                qk_rope_head_dim=8,
                v_head_dim=16,
                d_head=0,
            )
        return dataclasses.replace(cfg, **upd)
    if cfg.family == "ssm":
        return dataclasses.replace(
            cfg, **common, n_layers=2, ssm_state=16, ssm_head_dim=16, ssm_chunk=16
        )
    if cfg.family == "hybrid":
        return dataclasses.replace(
            cfg,
            **common,
            n_layers=4,
            attn_every=2,
            n_heads=4,
            n_kv_heads=4,
            d_head=16,
            ssm_state=16,
            ssm_head_dim=16,
            ssm_chunk=16,
        )
    if cfg.family == "audio":
        return dataclasses.replace(
            cfg, **common, n_layers=2, n_encoder_layers=2, n_heads=4, n_kv_heads=4, d_head=16
        )
    raise ValueError(cfg.family)
