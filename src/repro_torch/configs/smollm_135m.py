"""smollm-135m [dense] — llama-arch small [hf:HuggingFaceTB/SmolLM-135M].
30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152, head_dim 64, tied
embeddings. 9 heads don't divide the 16-wide model axis, so the sharding
profile is pure FSDP (this is also the ~100M end-to-end training example)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    vocab=49152,
    tie_embeddings=True,
    rope="standard",
    rope_theta=10000.0,
    sharding_profile="fsdp",
)

SMOKE = CONFIG.replace(
    n_layers=4, d_model=72, n_heads=3, n_kv_heads=1, head_dim=24, d_ff=192,
    vocab=512, attn_backend="full", remat=False,
)
