"""whisper-base [audio] — encoder-decoder; conv frontend is a stub
(`input_specs` supplies precomputed 1500-frame embeddings).
[arXiv:2212.04356; unverified]

Positions: sinusoidal (computed on the fly) for both encoder and decoder —
the real model uses learned decoder positions; the JAX package stubs them
so, and the port keeps its config.
"""
from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    head_dim=64,
    act="gelu",
    gated_mlp=False,
    encoder=EncoderConfig(n_layers=6, n_frames=1500, n_heads=8),
)
