"""deepseek-7b [dense] — llama-arch [arXiv:2401.02954].
30L d_model=4096 32H (GQA kv=32, i.e. MHA) d_ff=11008 vocab=102400."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab=102400,
    rope="standard",
    rope_theta=10000.0,
    sharding_profile="fsdp_tp",
)

SMOKE = CONFIG.replace(
    n_layers=4, d_model=96, n_heads=4, n_kv_heads=4, head_dim=24, d_ff=256,
    vocab=512, attn_backend="full", remat=False,
)
