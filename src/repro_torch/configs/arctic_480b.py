"""Snowflake Arctic 480B [hf:Snowflake/snowflake-arctic-base]: 128-expert
top-2 MoE with a parallel dense-FFN residual path."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab=32000,
    activation="silu",
    moe=MoEConfig(n_experts=128, top_k=2, d_ff_expert=4864, dense_d_ff=4864),
)
