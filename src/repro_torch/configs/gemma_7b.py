"""Gemma-7B [arXiv:2403.08295]: GeGLU, head_dim=256 (q dim 4096 != d_model
3072), RMSNorm(1+w), embedding scaling, tied embeddings."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab=256000,
    activation="geglu",
    tie_embeddings=True,
    embed_scale=True,
    norm_plus_one=True,
)
