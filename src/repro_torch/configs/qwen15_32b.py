"""Qwen1.5-32B [hf:Qwen/Qwen1.5-*]: llama-style with QKV bias."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    head_dim=128,
    d_ff=27392,
    vocab=152064,
    activation="silu",
    qkv_bias=True,
)
