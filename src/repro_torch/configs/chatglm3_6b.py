"""chatglm3-6b [dense] — RoPE applied to half the head dim ("2d"), GQA kv=2,
qkv bias [arXiv:2406.12793]. 28L d_model=4096 32H d_ff=13696 vocab=65024."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab=65024,
    rope="partial",
    rope_fraction=0.5,
    rope_theta=10000.0,
    qkv_bias=True,
    sharding_profile="fsdp_tp",
)

SMOKE = CONFIG.replace(
    n_layers=4, d_model=96, n_heads=4, n_kv_heads=2, head_dim=24, d_ff=256,
    vocab=512, attn_backend="full", remat=False,
)
