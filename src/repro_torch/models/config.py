"""Unified model configuration covering all assigned architecture families.

``vocab`` is the published vocabulary size; ``vocab_padded`` rounds it up to a
multiple of ``vocab_pad_to`` (the TP axis size) so the embedding table shards
cleanly — standard production practice; the loss masks the padding rows.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 256
    vocab: int = 512
    head_dim: int = 0  # 0 -> d_model // n_heads
    vocab_pad_to: int = 16

    # embeddings / readout
    tie_embeddings: bool = False

    # MLP flavor: 'swiglu' (3 matrices, llama) | 'gelu' (2, gpt-bigcode)
    mlp: str = "swiglu"

    # rope
    rope: str = "standard"  # standard | partial | mrope | none
    rope_theta: float = 10000.0
    rope_fraction: float = 0.5  # for partial rope (chatglm3)
    mrope_sections: tuple = (16, 24, 24)

    # attention
    qkv_bias: bool = False
    window: int = 0  # sliding-window size (mixtral); 0 = full causal
    attn_backend: str = "chunked"  # full | chunked | pallas
    attn_chunk: int = 1024

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    n_dense_layers: int = 0  # leading dense-FFN layers (deepseek-v2: 1)
    d_ff_dense: int = 0
    capacity_factor: float = 1.25
    moe_normalize: bool = True
    aux_loss_coef: float = 0.01
    moe_expert_sharding: str = "auto"  # auto | ep | tp (§Perf lever)

    # MLA (deepseek-v2)
    use_mla: bool = False
    q_lora: int = 0
    kv_lora: int = 0
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128

    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_chunk: int = 128
    d_inner: int = 0  # 0 -> 2 * d_model
    attn_every: int = 0  # hybrid: shared attention block period (zamba2)

    # enc-dec (seamless)
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    src_ratio: int = 4  # encoder frames = seq // src_ratio

    # vlm (qwen2-vl)
    n_vision_tokens: int = 0

    # numerics / training
    remat: bool = True
    remat_policy: str = "full"  # full | dots (save matmul outputs) | none
    ssd_bf16: bool = False      # bf16 intra-chunk SSD math (§Perf lever)
    norm_eps: float = 1e-6
    z_loss_coef: float = 1e-4

    # sharding profile: dp | fsdp | fsdp_tp (+ep decided by divisibility)
    sharding_profile: str = "fsdp_tp"

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            self.head_dim = self.d_model // self.n_heads
        if self.d_inner == 0:
            self.d_inner = 2 * self.d_model

    @property
    def vocab_padded(self) -> int:
        m = self.vocab_pad_to
        return ((self.vocab + m - 1) // m) * m

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter counting (for roofline MODEL_FLOPS) -------------------
    def param_counts(self):
        """Returns (total_params, active_params) — active counts only top-k
        experts for MoE."""
        d, V = self.d_model, self.vocab_padded
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.family in ("ssm",):
            per = _mamba2_params(self)
            total = emb + self.n_layers * per
            return total, total
        if self.family == "hybrid":
            per = _mamba2_params(self)
            attn = _attn_params(self) + 2 * d * d  # shared block + in/out glue
            total = emb + self.n_layers * per + attn
            return total, total
        if self.family == "encdec":
            enc = self.n_enc_layers * (_attn_params(self) + _ffn_params(self, self.d_ff))
            dec = self.n_dec_layers * (2 * _attn_params(self) + _ffn_params(self, self.d_ff))
            total = emb + enc + dec
            return total, total
        # decoder families
        attn = _attn_params(self)
        if self.n_experts:
            expert = 3 * d * self.d_ff_expert
            shared = 3 * d * self.d_ff_expert * self.n_shared_experts
            router = d * self.n_experts
            moe_layers = self.n_layers - self.n_dense_layers
            dense_ff = _ffn_params(self, self.d_ff_dense or self.d_ff)
            total = (emb + self.n_layers * attn + self.n_dense_layers * dense_ff
                     + moe_layers * (self.n_experts * expert + shared + router))
            active = (emb + self.n_layers * attn + self.n_dense_layers * dense_ff
                      + moe_layers * (self.top_k * expert + shared + router))
            return total, active
        total = emb + self.n_layers * (attn + _ffn_params(self, self.d_ff))
        return total, total


def _attn_params(cfg):
    d, hd = cfg.d_model, cfg.head_dim
    if cfg.use_mla:
        q = d * cfg.q_lora + cfg.q_lora * cfg.n_heads * (cfg.nope_head_dim + cfg.rope_head_dim)
        kv = d * (cfg.kv_lora + cfg.rope_head_dim)
        kv += cfg.kv_lora * cfg.n_heads * (cfg.nope_head_dim + cfg.v_head_dim)
        o = cfg.n_heads * cfg.v_head_dim * d
        return q + kv + o
    return d * hd * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)


def _ffn_params(cfg, d_ff):
    mats = 2 if cfg.mlp == "gelu" else 3
    return mats * cfg.d_model * d_ff


def _mamba2_params(cfg):
    d, di = cfg.d_model, cfg.d_inner
    H = di // cfg.ssm_headdim
    d_in_proj = 2 * di + 2 * cfg.ssm_ngroups * cfg.ssm_state + H
    conv_ch = di + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return d * d_in_proj + 4 * conv_ch + di * d + di
