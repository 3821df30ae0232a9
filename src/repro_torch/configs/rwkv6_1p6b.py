"""rwkv6-1.6b [ssm] — Finch: attention-free, data-dependent decay.
[arXiv:2404.05892; unverified]"""
from repro_torch.configs.base import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,                 # wkv heads = d_model / rwkv.head_dim
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    head_dim=64,
    act="relu",                 # rwkv channel-mix uses squared relu
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, tokenshift_lora=32, chunk=64),
)
