"""ModelConfig: one dataclass describing every architecture in the zoo."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 -> d_model // n_heads

    # --- attention flavor ---
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE

    # --- MoE ---
    n_experts: int = 0
    n_experts_per_tok: int = 0
    moe_d_ff: int = 0  # per-expert hidden dim
    n_shared_experts: int = 0
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    first_dense_layers: int = 0  # deepseek: first k layers are dense FFN

    # --- MLA (deepseek-v3) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    mtp: bool = False  # multi-token-prediction auxiliary head

    # --- SSM (mamba2 / zamba2) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv_kernel: int = 4
    attn_every: int = 0  # hybrid: shared attn block after every k ssm layers

    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    frontend: str = "none"  # none | audio_frames | vision_patches

    # --- training ---
    remat_policy: str = "minimal"  # none | minimal | full
    dtype: str = "bfloat16"
    # Fully unroll layer scans (cost-probe mode: XLA's cost_analysis counts a
    # while-loop body once, so roofline probes compile shallow UNROLLED
    # variants and extrapolate; see benchmarks/roofline.py).
    unroll_layers: bool = False

    # --- serving contract ---
    supports_decode: bool = True
    subquadratic: bool = False  # eligible for long_500k

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // max(self.n_heads, 1))

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-flops accounting)."""
        d, v = self.d_model, self.vocab_size
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += d * v
        dh = self.head_dim
        for _ in range(1):  # per-layer cost x n_layers below
            pass
        if self.family in ("dense", "moe", "vlm"):
            per = 0
            if self.use_mla:
                per += d * self.q_lora_rank + self.q_lora_rank * self.n_heads * (
                    self.qk_nope_head_dim + self.qk_rope_head_dim
                )
                per += d * (self.kv_lora_rank + self.qk_rope_head_dim)
                per += self.kv_lora_rank * self.n_heads * (
                    self.qk_nope_head_dim + self.v_head_dim
                )
                per += self.n_heads * self.v_head_dim * d
            else:
                per += d * self.n_heads * dh  # wq
                per += 2 * d * self.n_kv_heads * dh  # wk, wv
                per += self.n_heads * dh * d  # wo
            if self.is_moe:
                per_expert = 3 * d * self.moe_d_ff
                per_moe = self.n_experts * per_expert + d * self.n_experts
                per_moe += self.n_shared_experts * 3 * d * (self.shared_d_ff or self.moe_d_ff)
                dense_per = 3 * d * self.d_ff
                total += self.first_dense_layers * dense_per
                total += (self.n_layers - self.first_dense_layers) * per_moe
                total += self.n_layers * per
            else:
                per += 3 * d * self.d_ff
                total += self.n_layers * per
        elif self.family == "ssm":
            di, ds, hh = self.d_inner, self.ssm_state, self.ssm_heads
            per = d * (2 * di + 2 * ds + hh)  # in_proj (z,x,B,C,dt)
            per += di * d  # out_proj
            per += self.ssm_conv_kernel * (di + 2 * ds)
            total += self.n_layers * per
        elif self.family == "hybrid":
            di, ds, hh = self.d_inner, self.ssm_state, self.ssm_heads
            per = d * (2 * di + 2 * ds + hh) + di * d + self.ssm_conv_kernel * (di + 2 * ds)
            total += self.n_layers * per
            # one shared attention+mlp block
            total += 2 * d * self.n_heads * self.head_dim + 2 * d * self.n_kv_heads * self.head_dim
            total += 3 * d * self.d_ff
        elif self.family == "audio":
            dh = self.head_dim
            enc_per = 2 * d * self.n_heads * dh + 2 * d * self.n_kv_heads * dh + 2 * d * self.d_ff
            dec_per = enc_per + 2 * d * self.n_heads * dh + 2 * d * self.n_kv_heads * dh
            total += self.n_encoder_layers * enc_per + self.n_layers * dec_per
        if self.mtp:
            total += 3 * d * self.d_ff + 4 * d * self.n_heads * self.head_dim
        return int(total)

    def active_param_count(self) -> int:
        """Activated params per token (MoE: routed top-k + shared only)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        per_moe_active = (
            self.n_experts_per_tok * 3 * d * self.moe_d_ff
            + d * self.n_experts
            + self.n_shared_experts * 3 * d * (self.shared_d_ff or self.moe_d_ff)
        )
        per_moe_full = (
            self.n_experts * 3 * d * self.moe_d_ff
            + d * self.n_experts
            + self.n_shared_experts * 3 * d * (self.shared_d_ff or self.moe_d_ff)
        )
        moe_layers = self.n_layers - self.first_dense_layers
        return self.param_count() - moe_layers * (per_moe_full - per_moe_active)
