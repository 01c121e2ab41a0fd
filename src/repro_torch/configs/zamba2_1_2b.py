"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared (weight-tied) attention
blocks [arXiv:2411.15242]. 38L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=32000 ssm_state=64. Shared attention applied every 6 mamba layers
(6 groups + 2 tail layers)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab=32000,
    ssm_state=64,
    ssm_headdim=64,
    ssm_ngroups=1,
    ssm_chunk=128,
    d_inner=4096,
    attn_every=6,
    rope="standard",
    sharding_profile="fsdp_tp",
)

SMOKE = CONFIG.replace(
    n_layers=7, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
    vocab=512, ssm_state=16, ssm_headdim=16, d_inner=128, ssm_chunk=16,
    attn_every=3, attn_backend="full", remat=False,
)
