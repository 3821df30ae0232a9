"""deepseek-v2-lite-16b [moe] — MLA (kv_lora=512) + MoE 64 routed top-6,
2 shared experts, first layer dense. [arXiv:2405.04434; hf]

d_ff=1408 is the per-expert hidden size; the first dense layer uses 10944
(HF config).
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    act="silu",
    rope_theta=1e4,
    mla=MLAConfig(q_lora_rank=0, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, n_shared_experts=2, d_expert=1408,
                  dense_residual=False, first_dense_layers=1, dense_d_ff=10944),
)
