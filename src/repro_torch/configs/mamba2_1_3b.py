"""mamba2-1.3b [ssm] — SSD (state-space duality) [arXiv:2405.21060].
48L d_model=2048 attn-free vocab=50280 (padded to 50288) ssm_state=128,
headdim 64 (d_inner = 4096 -> 64 heads), tied embeddings. Attention-free:
long_500k decode is O(1)-state."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab=50280,
    tie_embeddings=True,
    ssm_state=128,
    ssm_headdim=64,
    ssm_ngroups=1,
    ssm_chunk=128,
    d_inner=4096,
    rope="none",
    sharding_profile="fsdp_tp",
)

SMOKE = CONFIG.replace(
    n_layers=4, d_model=64, d_inner=128, ssm_state=16, ssm_headdim=16,
    ssm_chunk=16, vocab=512, remat=False,
)
