"""qwen2-vl-72b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191].
80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064, qkv bias. The vision
frontend is a STUB per the assignment: input_specs() supplies precomputed
patch embeddings that replace the first n_vision_tokens positions, plus
(3, B, S) temporal/height/width M-RoPE position ids."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab=152064,
    rope="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1000000.0,
    qkv_bias=True,
    n_vision_tokens=256,
    sharding_profile="fsdp_tp",
)

SMOKE = CONFIG.replace(
    n_layers=4, d_model=96, n_heads=4, n_kv_heads=2, head_dim=24, d_ff=256,
    vocab=512, mrope_sections=(4, 4, 4), n_vision_tokens=8,
    attn_backend="full", remat=False,
)
