"""arctic-480b [moe] — 128 experts top-2 in parallel with a dense FFN
residual (Arctic's dense-MoE hybrid). [hf:Snowflake/snowflake-arctic-base; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    head_dim=128,
    act="silu",
    rope_theta=1e4,
    moe=MoEConfig(n_experts=128, top_k=2, n_shared_experts=0, d_expert=4864,
                  dense_residual=True, first_dense_layers=0, dense_d_ff=4864),
)
