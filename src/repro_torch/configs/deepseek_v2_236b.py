"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed experts
top-6 [arXiv:2405.04434]. 60L d_model=5120 128H d_ff=1536 (per expert)
vocab=102400. MLA: q_lora=1536, nope/v head dims 128, rope head dim 64.
160 experts shard 10-per-device over the 16-wide model axis (expert
parallelism)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=1536,
    d_ff_expert=1536,
    n_experts=160,
    top_k=6,
    n_shared_experts=2,
    vocab=102400,
    use_mla=True,
    q_lora=1536,
    kv_lora=512,
    rope_head_dim=64,
    nope_head_dim=128,
    v_head_dim=128,
    moe_normalize=False,
    rope="standard",
    rope_theta=10000.0,
    sharding_profile="fsdp_tp",
)

SMOKE = CONFIG.replace(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=48, d_ff_expert=48, n_experts=8, top_k=2, n_shared_experts=1,
    vocab=512, q_lora=32, kv_lora=24, rope_head_dim=8, nope_head_dim=16,
    v_head_dim=16, attn_backend="full", remat=False,
    capacity_factor=4.0,  # = E/top_k: no token dropping at smoke scale
)
