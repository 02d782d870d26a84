"""Granite-3.0 1B-a400m [hf:ibm-granite]: 32-expert top-8 MoE, GQA kv=8."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab=49155,
    activation="silu",
    moe=MoEConfig(n_experts=32, top_k=8, d_ff_expert=512),
)
