"""Gemma-2 9B [arXiv:2408.00118]: alternating local(4096)/global attention,
attention + final logit softcaps, post-norms, GQA kv=8."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab=256000,
    activation="geglu",
    tie_embeddings=True,
    embed_scale=True,
    norm_plus_one=True,
    block_pattern=("local", "attn"),
    local_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    post_norms=True,
)
