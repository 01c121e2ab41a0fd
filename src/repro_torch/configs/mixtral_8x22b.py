"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention
[arXiv:2401.04088]. 56L d_model=6144 48H (GQA kv=8) d_ff=16384 (per expert)
vocab=32768, window=4096. SWA makes long_500k decodable (KV bounded by the
window). 8 experts < the 16-wide model axis, so experts replicate and each
expert's d_ff tensor-shards (see repro.sharding.rules)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    d_ff_expert=16384,
    n_experts=8,
    top_k=2,
    window=4096,
    vocab=32768,
    rope="standard",
    rope_theta=1000000.0,
    moe_normalize=True,
    sharding_profile="fsdp_tp",
)

SMOKE = CONFIG.replace(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    d_ff_expert=128, n_experts=4, top_k=2, window=16, vocab=512,
    attn_backend="full", remat=False,
    capacity_factor=2.0,  # = E/top_k: no token dropping at smoke scale
)
