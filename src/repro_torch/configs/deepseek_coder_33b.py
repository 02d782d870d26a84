"""DeepSeek-Coder 33B [arXiv:2401.14196]: llama-arch, deep-narrow, GQA kv=8."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab=32256,
    activation="silu",
)
