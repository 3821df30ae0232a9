"""gemma2-2b [dense] — local+global alternating attention, logit softcaps.
[arXiv:2408.00118; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    d_ff=9216,
    vocab_size=256000,
    head_dim=256,
    act="gelu",
    rope_theta=1e4,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    sliding_window=4096,
    local_global_every=2,        # every 2nd layer is global, others local
    query_pre_attn_scalar=256.0,
    post_norms=True,
    embed_scale=True,
    rms_plus_one=True,
    tie_embeddings=True,
)
