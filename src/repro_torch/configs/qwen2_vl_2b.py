"""qwen2-vl-2b [vlm] — M-RoPE backbone; dynamic-resolution patch frontend is a
stub (`input_specs` supplies M-RoPE position streams; smoke tests splice
precomputed patch embeddings). [arXiv:2409.12191; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    head_dim=128,
    qkv_bias=True,
    act="silu",
    rope_theta=1e6,
    mrope=True,
    mrope_sections=(16, 24, 24),   # temporal/height/width rotary half-dims
    tie_embeddings=True,
)
