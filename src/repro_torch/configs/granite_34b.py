"""granite-34b [dense] — code model [arXiv:2405.04324].
88L d_model=6144 48H (GQA kv=1, i.e. MQA) d_ff=24576 vocab=49152.
GPT-BigCode-style non-gated (2-matrix) MLP — that is what lands the published
config at 34B; a gated swiglu at d_ff=24576 would be 47B."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    mlp="gelu",
    vocab=49152,
    rope="standard",
    rope_theta=10000.0,
    sharding_profile="fsdp_tp",
)

SMOKE = CONFIG.replace(
    n_layers=4, d_model=96, n_heads=6, n_kv_heads=1, head_dim=16, d_ff=384,
    vocab=512, attn_backend="full", remat=False,
)
