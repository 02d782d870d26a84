"""RWKV-6 'Finch' 3B [arXiv:2404.05892]: attention-free, data-dependent
decay time-mix; 40 heads x 64 head_dim."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,                    # d_model / rwkv_head_dim
    n_kv_heads=40,
    d_ff=8960,
    vocab=65536,
    activation="silu",
    block_pattern=("rwkv",),
    rwkv_head_dim=64,
)
