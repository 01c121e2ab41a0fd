"""seamless-m4t-large-v2 [audio] — enc-dec multimodal backbone
[arXiv:2308.11596]. 24L enc + 24L dec, d_model=1024 16H (GQA kv=16) d_ff=8192
vocab=256206 (padded to 256208 for the 16-way TP axis). The audio frontend is
a STUB per the assignment: input_specs() supplies precomputed frame
embeddings at src_len = seq // 4."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=48,          # 24 enc + 24 dec (bookkeeping; stacks below)
    n_enc_layers=24,
    n_dec_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab=256206,
    src_ratio=4,
    rope="standard",
    sharding_profile="fsdp_tp",
)

SMOKE = CONFIG.replace(
    n_layers=4, n_enc_layers=2, n_dec_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, head_dim=16, d_ff=128, vocab=518, attn_backend="full",
    remat=False,
)
