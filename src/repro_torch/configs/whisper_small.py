"""Whisper-small [arXiv:2212.04356]: enc-dec, conv frontend stubbed to
precomputed frame embeddings (1500 positions), learned positions, GELU."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="whisper-small",
    family="encdec",
    n_layers=12,                   # decoder layers
    encoder_layers=12,
    encoder_len=1500,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab=51865,
    activation="gelu",
    rope_theta=0.0,                # learned absolute positions, no rope
)
