"""Qwen2-VL-7B backbone [arXiv:2409.12191]: GQA kv=4, M-RoPE, vision stub."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab=152064,
    activation="silu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),   # (t, h, w) halves of the 64 rotary pairs
    vision_stub_patches=1024,      # frontend stub supplies patch embeddings
)
