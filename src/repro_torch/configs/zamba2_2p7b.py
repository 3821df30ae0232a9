"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; hf]

54 Mamba2 layers; a weight-shared (attention + FFN) transformer block is
applied every 6 SSM layers (9 applications), following the Zamba2 design of
reusing one shared block throughout the depth.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    head_dim=80,
    act="gelu",
    rope_theta=1e4,
    attn_every=6,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_dim=4, chunk=64),
)
